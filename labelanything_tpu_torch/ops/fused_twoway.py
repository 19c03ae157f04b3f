"""The whole TwoWayTransformer in one kernel (counterpart of
``labelanything_tpu/ops/fused_twoway.py``).

The prompt encoder's fusion and the mask decoder both run a SAM-style
two-way transformer over G instances of S image tokens against N sparse or
class tokens: ``depth`` blocks (token self-attention, token-to-image
attention, MLP, image-to-token attention, four LayerNorms) and a final
token-to-image attention with its norm. As separate modules that is about
50 small launches a call; :func:`fused_twoway_transformer` runs it as one
CUDA kernel (``csrc/fused_twoway.cu``). In bf16 one instance is a
thread-block cluster of :func:`twoway_cluster` blocks, which cut its image
rows and its token-side products between them; in fp32 one block.

* :func:`twoway_plain` is the same function in plain tensor code, on any
  device and dtype: what the kernel is held against, what a CPU tensor
  takes, and what the backward differentiates.
* :func:`twoway_params` collects a ``TwoWayTransformer`` module's weights
  into the flat tuple both take (the module's own parameters, in torch's
  (out, in) layout; no copy).
* :func:`fused_twoway_compiled` says which calls the kernel is compiled for
  (fp32 and bf16); :func:`fused_twoway_ok`, the route rule, admits the
  bf16 ones: a caller routes by it, never by a failed build or launch.
* :func:`fused_twoway_transformer` is a ``torch.autograd.Function``: kernel
  forward on a CUDA tensor (or it raises), plain forward on a CPU tensor or
  inside :func:`..flash_attention.plain_attention`; the backward recomputes
  :func:`twoway_plain` under autograd on any device, as the JAX package's
  ``custom_vjp`` recomputes its plain reference. Each launch adds one to
  ``flash_attention.LAUNCHES["fused_twoway"]``.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import flash_attention as fa

# params-tuple layout per Attention: (Wq, bq, Wk, bk, Wv, bv, Wo, bo)
_ATTN_N = 8
# per block: self_attn, norm1, token-to-image, norm2, mlp (lin1, lin2),
# norm3, image-to-token, norm4
_LAYER_N = _ATTN_N * 3 + 2 * 4 + 4
LN_EPS = 1e-5

# what csrc/fused_twoway.cu is compiled for
KERNEL_DIM = 256
KERNEL_HEADS = 8
KERNEL_DOWNSAMPLE = 2
KERNEL_MAX_TOKENS = 8
KERNEL_MAX_MLP = 2048
_MAX_GRID_X = 2 ** 31 - 1
# the bf16 kernel's blocks: 8 warps, each taking 16-row tiles of an
# instance's image rows; at most 8 blocks an instance (portable clusters)
KERNEL_WARPS = 8
KERNEL_TILE_ROWS = 16
KERNEL_CLUSTERS = (1, 2, 4, 8)
KERNEL_MAX_CLUSTER = KERNEL_CLUSTERS[-1]


def twoway_param_count(depth: int) -> int:
    return depth * _LAYER_N + _ATTN_N + 2


def _attention_params(attn) -> Tuple[torch.Tensor, ...]:
    return tuple(p for proj in (attn.q_proj, attn.k_proj, attn.v_proj,
                                attn.out_proj)
                 for p in (proj.weight, proj.bias))


def twoway_params(transformer) -> Tuple[torch.Tensor, ...]:
    """The flat parameter tuple of a ``models.transformer.TwoWayTransformer``
    in the order :func:`twoway_plain` consumes: per block self-attention,
    norm1, token-to-image attention, norm2, MLP, norm3, image-to-token
    attention, norm4; then the final attention and its norm. Every entry is
    the module's own parameter (weights (out, in), as ``nn.Linear`` keeps
    them)."""
    out = []
    for layer in transformer.layers:
        out += _attention_params(layer.self_attn)
        out += (layer.norm1.weight, layer.norm1.bias)
        out += _attention_params(layer.cross_attn_token_to_image)
        out += (layer.norm2.weight, layer.norm2.bias)
        out += (layer.mlp.lin1.weight, layer.mlp.lin1.bias,
                layer.mlp.lin2.weight, layer.mlp.lin2.bias)
        out += (layer.norm3.weight, layer.norm3.bias)
        out += _attention_params(layer.cross_attn_image_to_token)
        out += (layer.norm4.weight, layer.norm4.bias)
    out += _attention_params(transformer.final_attn_token_to_image)
    out += (transformer.norm_final_attn.weight,
            transformer.norm_final_attn.bias)
    return tuple(out)


def _ln(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
        ) -> torch.Tensor:
    """LayerNorm with statistics in fp32 (fp64 for fp64 inputs), returned in
    the input's dtype, as ``models.common.LayerNorm``."""
    ft = fa._float_type(x)
    return F.layer_norm(x.to(ft), x.shape[-1:], weight.to(ft), bias.to(ft),
                        LN_EPS).to(x.dtype)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               params: Sequence[torch.Tensor], heads: int) -> torch.Tensor:
    """``models.common.Attention`` on raw parameters: projections in the
    inputs' dtype, scores and softmax in fp32 (fp64 for fp64), the
    probabilities cast back before the value product."""
    wq, bq, wk, bk, wv, bv, wo, bo = (p.to(q.dtype) for p in params)
    ft = fa._float_type(q)

    def split(x):
        b, n, c = x.shape
        return x.reshape(b, n, heads, c // heads).transpose(1, 2)

    qp, kp, vp = (split(F.linear(x, w, b))
                  for x, w, b in ((q, wq, bq), (k, wk, bk), (v, wv, bv)))
    logits = torch.matmul(qp.to(ft), kp.to(ft).transpose(-1, -2)) \
        * qp.shape[-1] ** -0.5
    out = torch.matmul(torch.softmax(logits, dim=-1).to(vp.dtype), vp)
    b, _, n, _ = out.shape
    return F.linear(out.transpose(1, 2).reshape(b, n, -1), wo, bo)


def twoway_block(keys, queries, q0, key_pe, params, heads: int,
                 act: Callable, first: bool):
    """One TwoWayAttentionBlock on its ``_LAYER_N`` parameters; ``key_pe``
    (1, S, D). The first block's self-attention has no positional term and
    replaces the queries."""
    self_p, n1, t2i, n2 = params[:8], params[8:10], params[10:18], params[18:20]
    w1, b1, w2, b2 = (p.to(keys.dtype) for p in params[20:24])
    n3, i2t, n4 = params[24:26], params[26:34], params[34:36]
    if first:
        queries = _attention(queries, queries, queries, self_p, heads)
    else:
        q = queries + q0
        queries = queries + _attention(q, q, queries, self_p, heads)
    queries = _ln(queries, *n1)
    queries = _ln(queries + _attention(queries + q0, keys + key_pe, keys,
                                       t2i, heads), *n2)
    queries = _ln(queries + F.linear(act(F.linear(queries, w1, b1)), w2, b2),
                  *n3)
    keys = _ln(keys + _attention(keys + key_pe, queries + q0, queries, i2t,
                                 heads), *n4)
    return queries, keys


def twoway_final(keys, queries, q0, key_pe, params, heads: int):
    """The final token-to-image attention and its norm on their
    ``_ATTN_N + 2`` parameters."""
    return _ln(queries + _attention(queries + q0, keys + key_pe, keys,
                                    params[:_ATTN_N], heads),
               *params[_ATTN_N:])


def twoway_plain(keys: torch.Tensor, queries: torch.Tensor,
                 key_pe: torch.Tensor, params: Sequence[torch.Tensor],
                 depth: int, heads: int, act: Callable = F.relu
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-way transformer as plain tensor ops.

    keys (G, S, D) image tokens, queries (G, N, D) initial tokens (also the
    query positional source of every stage), key_pe (S, D) shared by all
    instances, ``params`` as :func:`twoway_params` gives them. Returns
    (queries (G, N, D), keys (G, S, D)) in the inputs' dtype."""
    if len(params) != twoway_param_count(depth):
        raise ValueError(f"{len(params)} parameters, expected "
                         f"{twoway_param_count(depth)} for depth {depth}")
    q0 = queries
    key_pe = key_pe[None]
    for layer in range(depth):
        queries, keys = twoway_block(
            keys, queries, q0, key_pe,
            params[layer * _LAYER_N:(layer + 1) * _LAYER_N], heads, act,
            first=layer == 0)
    queries = twoway_final(keys, queries, q0, key_pe,
                           params[depth * _LAYER_N:], heads)
    return queries, keys


def fused_twoway_compiled(device: torch.device, dtype: torch.dtype,
                          tokens: int, dim: int, heads: int, mlp_dim: int,
                          downsample: int, act: Callable = F.relu) -> bool:
    """Whether the kernel is compiled for a call: a pure function of
    device, dtype and shape. It is compiled for the decode path's
    transformer: width 256, 8 heads, cross-attention downsample 2, ReLU, an
    MLP width that is a multiple of 32 up to 2048, and at most 8 tokens an
    instance (the token side of its tensor-core tiles), in fp32 or bf16, on
    a CUDA device."""
    return (device.type == "cuda"
            and dtype in (torch.float32, torch.bfloat16)
            and dim == KERNEL_DIM and heads == KERNEL_HEADS
            and downsample == KERNEL_DOWNSAMPLE
            and 1 <= tokens <= KERNEL_MAX_TOKENS
            and mlp_dim % 32 == 0 and 32 <= mlp_dim <= KERNEL_MAX_MLP
            and act is F.relu)


def fused_twoway_ok(device: torch.device, dtype: torch.dtype, tokens: int,
                    dim: int, heads: int, mlp_dim: int, downsample: int,
                    act: Callable = F.relu) -> bool:
    """Whether ``TwoWayTransformer`` routes a call to the kernel on the
    card: what :func:`fused_twoway_compiled` admits, in bf16 only. The fp32
    kernel runs on the CUDA cores and is about nine times slower than the
    module path on the tensor cores, so fp32 goes the module path; the fp32
    kernel stays for parity checks, which call it directly. Anything else
    goes the module path too."""
    return dtype == torch.bfloat16 and fused_twoway_compiled(
        device, dtype, tokens, dim, heads, mlp_dim, downsample, act)


def twoway_cluster(g: int, s: int, capacity: Dict[int, int]) -> int:
    """Blocks a cluster of the bf16 kernel gives each of ``g`` instances of
    ``s`` image rows, where ``capacity`` maps each cluster size of
    :data:`KERNEL_CLUSTERS` to the clusters the card holds at once
    (:func:`cluster_capacity`): from 1, doubled up to 8 while all ``g``
    doubled clusters still fit at once and the cluster's 8 C warps still
    have fewer than the instance's 16-row tiles (ceil(s / 16) > 8 C) to
    share. The prompt encoder's 96 instances of 900 rows take 1."""
    tiles = -(-s // KERNEL_TILE_ROWS)
    c = 1
    while (c < KERNEL_MAX_CLUSTER and g <= capacity[2 * c]
           and KERNEL_WARPS * c < tiles):
        c *= 2
    return c


# cluster capacities by CUDA device index
_CAPACITY: Dict[int, Dict[int, int]] = {}


def cluster_capacity(device: torch.device) -> Dict[int, int]:
    """Clusters of each size of :data:`KERNEL_CLUSTERS` of the bf16 kernel
    that the card holds at once, as CUDA's occupancy calculator counts
    them (``la_fused_twoway_max_clusters``); asked once a device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _CAPACITY:
        from . import _build

        lib = _build.load()
        with torch.cuda.device(index):
            counts = {c: lib.la_fused_twoway_max_clusters(c)
                      for c in KERNEL_CLUSTERS}
        for c, count in counts.items():
            if count < 0:
                _build.check(lib, -count, "la_fused_twoway_max_clusters")
        _CAPACITY[index] = counts
    return _CAPACITY[index]


def pack_params(params: Sequence[torch.Tensor], dtype: torch.dtype
                ) -> torch.Tensor:
    """The parameters as one flat buffer of ``dtype`` in tuple order, the
    kernel's operand. The bf16 kernel reads the matrices as ``nn.Linear``
    keeps them, (out, in): the tensor cores' column operand. The fp32
    kernel walks them with neighbouring threads on neighbouring outputs, so
    its buffer holds them transposed, (in, out)."""
    params = [p.detach() for p in params]     # the kernel is forward only
    if dtype == torch.float32:
        params = [p.t() if p.dim() == 2 else p for p in params]
    return torch.cat([p.reshape(-1) for p in params]).to(dtype)


# packed parameter buffers by (id of the first parameter, dtype): weak
# references to the parameters, their storage and version counters at
# packing time, the buffer
_PACKED: Dict[tuple, tuple] = {}


def packed_params(params: Sequence[torch.Tensor], dtype: torch.dtype
                  ) -> torch.Tensor:
    """:func:`pack_params`, kept until a parameter is replaced, moved or
    written in place (its version counter moves), so that serving packs a
    transformer's weights once and not at every call."""
    key = (id(params[0]), dtype)
    state = [(p.data_ptr(), p._version) for p in params]
    hit = _PACKED.get(key)
    if hit is not None and hit[1] == state and len(hit[0]) == len(params) \
            and all(ref() is p for ref, p in zip(hit[0], params)):
        return hit[2]
    for stale in [k for k, v in _PACKED.items() if v[0][0]() is None]:
        del _PACKED[stale]
    flat = pack_params(params, dtype)
    _PACKED[key] = ([weakref.ref(p) for p in params], state, flat)
    return flat


def fused_twoway_packed(keys: torch.Tensor, queries: torch.Tensor,
                        key_pe: torch.Tensor, flat: torch.Tensor, depth: int,
                        heads: int, mlp_dim: int, downsample: int,
                        act: Callable = F.relu
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``la_fused_twoway`` on a parameter buffer packed by
    :func:`pack_params` in the operands' dtype: (queries_out, keys_out).
    CUDA tensors only; no gradient."""
    g, s, d = keys.shape
    n = queries.shape[1]
    for name, x in (("keys", keys), ("queries", queries), ("key_pe", key_pe),
                    ("flat", flat)):
        if x.device.type != "cuda":
            raise ValueError(f"the fused_twoway kernel needs CUDA tensors, "
                             f"got {name} on {x.device}")
        if x.dtype != keys.dtype:
            raise TypeError(f"{name} is {x.dtype}, keys {keys.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not fused_twoway_compiled(keys.device, keys.dtype, n, d, heads,
                                 mlp_dim, downsample, act):
        raise ValueError(
            f"the fused_twoway kernel is not compiled for {keys.dtype} "
            f"width {d}, {heads} heads, downsample {downsample}, MLP "
            f"{mlp_dim}, {n} tokens (see fused_twoway_compiled)")
    if not 1 <= g * KERNEL_MAX_CLUSTER <= _MAX_GRID_X or s < 1:
        raise ValueError(f"{g} instances of {s} image tokens")
    from . import _build

    lib = _build.load()
    q_out, k_out = torch.empty_like(queries), torch.empty_like(keys)
    is_bf16 = keys.dtype == torch.bfloat16
    cluster = (twoway_cluster(g, s, cluster_capacity(keys.device))
               if is_bf16 else 1)
    # the fp32 kernel keeps two image-side projections of every instance
    scratch = (None if is_bf16 else
               torch.empty((g, 2, s, d // downsample), dtype=torch.float32,
                           device=keys.device))
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.la_fused_twoway(
            keys.data_ptr(), queries.data_ptr(), key_pe.data_ptr(),
            flat.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
            None if is_bf16 else scratch.data_ptr(), g, s, n, d, heads,
            mlp_dim, depth, downsample, int(is_bf16), cluster, stream)
    _build.check(lib, err, "la_fused_twoway")
    fa.LAUNCHES["fused_twoway"] += 1
    return q_out, k_out


def _launch(keys: torch.Tensor, queries: torch.Tensor, key_pe: torch.Tensor,
            params: Sequence[torch.Tensor], depth: int, heads: int,
            act: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a parameter tuple: (queries_out, keys_out)."""
    if keys.device.type != "cuda":
        raise ValueError(f"the fused_twoway kernel needs CUDA tensors, got "
                         f"keys on {keys.device}")
    internal = params[_ATTN_N + 2].shape[0]    # token-to-image q_proj rows
    mlp_dim = params[2 * _ATTN_N + 4].shape[0]
    return fused_twoway_packed(
        keys, queries, key_pe, packed_params(params, keys.dtype), depth,
        heads, mlp_dim, keys.shape[2] // internal, act)


class FusedTwoWay(torch.autograd.Function):
    """``(keys, queries, key_pe, *params) -> (queries, keys)``: the kernel
    forward and a backward that recomputes :func:`twoway_plain` under
    autograd on any device (the JAX package has no backward kernel here
    either). CPU tensors, and any tensor inside ``plain_attention()``, take
    the plain forward."""

    @staticmethod
    def forward(ctx, depth, heads, act, keys, queries, key_pe, *params):
        ctx.args = (depth, heads, act)
        ctx.save_for_backward(keys, queries, key_pe, *params)
        if fa._plain_requested or keys.device.type == "cpu":
            return twoway_plain(keys, queries, key_pe, params, *ctx.args)
        return _launch(keys, queries, key_pe, params, *ctx.args)

    @staticmethod
    def backward(ctx, dq, dk):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[3:])]
        with torch.enable_grad():
            q, k = twoway_plain(inputs[0], inputs[1], inputs[2], inputs[3:],
                                *ctx.args)
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad((q, k), wanted, (dq, dk),
                                         allow_unused=True))
        return (None, None, None,
                *(next(grads) if x.requires_grad else None for x in inputs))


def fused_twoway_transformer(keys: torch.Tensor, queries: torch.Tensor,
                             key_pe: torch.Tensor,
                             params: Sequence[torch.Tensor], depth: int,
                             heads: int, act: Callable = F.relu
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole TwoWayTransformer in one kernel launch.

    keys (G, S, D) flattened image tokens per instance, queries (G, N, D)
    initial tokens, key_pe (S, D) the image positional encoding shared by
    all instances, ``params`` from :func:`twoway_params`. Returns (queries,
    keys) like the module. Differentiable in every tensor argument."""
    if keys.dim() != 3 or queries.dim() != 3 or key_pe.dim() != 2:
        raise ValueError(f"keys, queries and key_pe must be 3-, 3- and 2-D, "
                         f"got {tuple(keys.shape)}, {tuple(queries.shape)}, "
                         f"{tuple(key_pe.shape)}")
    g, s, d = keys.shape
    if queries.shape[0] != g or queries.shape[2] != d \
            or tuple(key_pe.shape) != (s, d):
        raise ValueError(f"keys {tuple(keys.shape)}, queries "
                         f"{tuple(queries.shape)} and key_pe "
                         f"{tuple(key_pe.shape)} do not fit together")
    if len(params) != twoway_param_count(depth):
        raise ValueError(f"{len(params)} parameters, expected "
                         f"{twoway_param_count(depth)} for depth {depth}")
    return FusedTwoWay.apply(depth, heads, act, keys, queries, key_pe,
                             *params)
