"""Drive the PyTorch port's paths once on one NVIDIA GPU: ViT-B serving and a
fine-tune training step, the ViT-H and ViT-L encoders (serving and
embedding), episode decode on precomputed embeddings, the affinity decoder
on SAM embeddings at 1024 px, then the SAM encoder's two opt-in kernels
(the fused windowed block and int8 scores) served and embedding, the
full-size golden fixtures, training on precomputed embeddings (the flagship
``lam_no_vit`` and the affinity model), the embedding-cache workflow
(embed, train with a checkpoint and a resume, save, reload, serve), the
training entry point (``mae.yaml`` through the CLI, ``Run`` and the
episode engine on a synthetic COCO root), the evaluation protocols
(``validate --checkpoint``'s fold x rerun protocol on that run, PASCAL-5i
on a synthetic VOC root, the COCO test protocol), the images path, and
the ResNet / VGG baselines (PANet, PPNet, DENet, BAM, HDMNet) through
``cli validate``, DCAMA and FPTrans, and the LAM variants of 19 files of
``parameters/``.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught but
the out-of-memory error of phase 18's recompute at once, which it
reports):

0. card: a CUDA device must be present; prints its name and power limit;
1. build: compiles the kernels (``labelanything_tpu_torch/
   csrc``) with nvcc for sm_90a, one compiler per source;
2. kernels: each kernel against its plain PyTorch twin at the shapes its
   path gives it (forward: serving, 1 image / 25 windows; backward: the
   training step, 6 images / 150 windows, where the forward kernels, which
   then also write the log-sum-exp, are held against their twins again),
   fp32 (rtol = atol = 1e-4: the sums run in another order) and bf16
   (|kernel - plain| <= 4 x |plain_bf16 - plain_fp32| + 1e-6, worst
   element, per output); kernel, plain twin and one library call
   (``scaled_dot_product_attention`` on the expanded bias; forward +
   backward for a backward kernel) are timed, per wrapper call and, for
   kernel and library call, on the device (back-to-back launches between
   two events), each kernel's ratio to its call printed, and the least
   time the card could take is reckoned from the shapes. The global
   kernel (K1, in bf16 at 1024 px the wgmma kernel that ``global_kernel``
   names, found by name in a profiler pass) is held again at 1, 6 and 8
   images with ViT-B's 12 and ViT-L's 16 heads, on its output and on the
   log-sum-exp it writes for the backward, and timed at the training
   step's 6 images with the log-sum-exp and at the embedding batch of 8.
   The windowed
   kernel (K2) is held and timed again at the embedding batch's 200
   windows and at ViT-L's 16 heads. The global kernels take a
   shorter bias path when a row of the key grid is 64 wide, as at 1024 px;
   their general path is held against the twins on a 48 x 48 grid. The
   packed kernels (head width 80, ViT-H's) are held the same way on the
   token-major view the encoder hands them: global (1 image, 16 heads) and
   windowed (25 windows), the strided view against the contiguous tensor
   bit for bit, the general bias path on 48 x 48, and a gradient through
   the autograd function (kernel forward, plain backward) against autograd
   through the plain twin; the windowed one again at the embedding batch's
   200 windows. The backward kernels must give the same bits on a second
   run (no atomics), and the global backward's three parts (delta pass,
   query cut, key cut) are timed apart by a profiler pass, by kernel
   name. Each kernel's share of its bound (bound over device time) is
   printed. The score-dtype microbench runs once at batch 1: its variants
   of the packed global kernel against the twin, timed. The fused
   TwoWayTransformer kernel is held against ``twoway_plain`` at the
   decode path's two call sites (96 and 16 instances of 900 image tokens
   against 6 tokens, width 256; in bf16 one instance a cluster of the
   blocks ``twoway_cluster`` gives, 1 and 4 on the H100) and at phase
   17's training step's (48 and 8 instances: clusters of 2 and 8), both
   outputs,
   fp32 and bf16 by the same
   rules, with a gradient through its autograd function against autograd
   through the twin; kernel, twin and the module path are timed. The plain
   flash kernel is held against ``flash_attention_plain`` at the affinity
   decoder's call (6 x 8 heads, 4096 queries against 8192 keys, 32 wide:
   the Hopper kernel), at a ragged 1152 tokens and at head widths 64 (the
   Hopper kernel), 128 and 256 (the mma.sync kernel), each launch counted
   under its route's key, fp32 and bf16 by the same rules, its strided views against contiguous tensors
   bit for bit, a gradient through its autograd function against autograd
   through the twin; kernel, twin and ``scaled_dot_product_attention`` are
   timed and the bound counts the exponentials beside the products. The
   fused windowed block (K8) is held against ``fused_window_plain`` at one
   1024-px image's windowed block (25 windows, 64 x 64 padded to 70 x 70)
   of ViT-B (12 heads of 64) and ViT-H (16 heads of 80), fp32 and bf16;
   kernel, twin and the unfused kernel path it replaces (partition copy,
   K2 or the packed windowed kernel, projection, unpartition, residual)
   are timed. The int8 score branch of the global kernel is held against
   ``relpos_attention_int8_plain`` at ViT-B's global block (1, 4096,
   2304), the plain bf16 / fp32 pair being the int8 twin on bf16 and on
   fp32-cast inputs; kernel, twin, SDPA on the expanded bias and the bf16
   kernel are timed, and its drift from the bf16 kernel printed;
   The wgmma kernels' launches are audited (ROADMAP C8): 20 calls of K1
   and of K5 global on distinct inputs, each output written into a NaN
   block and held to the twin, counted by ``LAUNCHES``, by CUDA events and
   by profiler passes, which must see all 20 (as must the backward's parts
   and the route checks: the profiler drops the records of a pass's first
   kernels, so every counting pass opens with 256 sentinel kernels and is
   read only if it kept one of those, else made again);
3. slice parity: a 1-way 1-shot episode at 1024 px through the full fp32
   slice on the GPU (kernels) and on the CPU (plain twins), logits within
   rtol 1e-3 / atol 5e-4 and argmax agreement > 0.999;
4. serving: ``LabelAnything`` in bf16, ``generate_class_embeddings`` on a
   1-way 5-shot support set, then 3 ``predict`` requests; checks shapes,
   finite logits, the 0 / -inf pad fill and the kernels' launch counts; a
   profiler pass over one request;
5. step parity: one fp32 training pass (forward, focal loss, backward) of
   a 1-way 1-shot episode on the card twice from the same weights and
   class rows, through the kernels and through the plain twins
   (``plain_attention()``): loss within 1e-5 relative, every parameter's
   gradient within a relative L2 distance of GRAD_REL_L2 (gradients below
   GRAD_FLOOR of the whole gradient's norm are held to that floor); the
   same pass in bf16, whose whole gradient must point where the fp32 one
   does (cosine >= BF16_GRAD_COSINE); then five fp32 AdamW steps through
   the kernels on that episode: the loss falls on the first update and is
   lower after step 5 than at step 1;
6. training: the fine-tune configuration of the JAX package's
   ``bench_finetune`` in bf16 (2 episodes of 1-way 2-shot, 6 images a
   step, masks, focal loss with class weighting, AdamW 5e-5, encoder
   trainable) through ``init_train_state`` / ``make_train_step``: 1 warm-up
   and 4 timed steps on one batch; every loss finite, every parameter
   with a gradient moved, launch counts per step; this batch's fp32 and
   bf16 gradient norms are reported (the fp32 one is below bf16's rounding
   noise with these weights, so these losses cannot show the fall); a
   profiler pass over two more steps (kernel time by name, the device's
   busy share); then one step with the backbone frozen: no
   backward kernel, encoder unchanged;
7. ViT-H parity (fp32): ``build_vit_h`` at full width and depth on one
   1024-px image through the packed kernels against the same call inside
   ``plain_attention()`` (rtol 1e-3 / atol 5e-4); then the ``lam_h`` slice
   with the encoder cut to 4 blocks (global at 1, 3; full width) on
   the card against the CPU, as phase 3;
8. ViT-H and ViT-L serving (bf16): ``lam_h`` (1-way 5-shot support set, 3
   requests) and ``lam_l`` (1-shot, 1 request) through ``LabelAnything``
   with phase 4's checks; ``lam_h`` launches 4 packed global + 28 packed
   windowed kernels an encoder call and no lanes kernel, ``lam_l`` 4 global
   + 20 windowed lanes kernels; a profiler pass over one ``lam_h`` request;
9. embedding: ``build_vit_h`` and ``build_vit_l`` in bf16 with the SAM neck
   on a batch of 8 images at 1024 px: 1 warm-up and 3 timed calls, images
   per second, peak memory, output (8, 64, 64, 256) finite;
10. decode parity (fp32): ``lam_no_vit`` (the model block of
   parameters/trainval/coco20i/mae.yaml: 480 px, 768-wide embeddings, width
   256) on 2 episodes of 5-way 1-shot, with and without mask prompts, on
   the card against the CPU (plain twins) as phase 3, fp32 taking the
   module path (the fused kernel's route rule admits bf16 only); the same
   forward with the fp32 kernel forced (route rule patched to what the
   kernel is compiled for: 2 launches) against the CPU, its forward time
   beside the module path's; and on the card the shared-keys form of the
   prompt encoder's fusion against the expanded one, same tolerance;
11. decode (bf16): the JAX package's ``bench_decode``: two batches of 16
   episodes of 5-way 1-shot alternating, 1 warm-up and 8 timed steps, with
   masks and without: episodes per second, peak memory, logits (16, 6, 480,
   480) finite in the valid region, 2 fused-kernel launches a step; the
   split entry points; a profiler pass; the same steps inside
   ``plain_attention()`` (the module path) and with the shared-keys form;
12. affinity parity (fp32): ``lam_no_vit`` with ``few_type: Affinity`` (the
   model block of parameters/trainval/other/Affinity/4.2_Affinity_SAM.yaml
   without its transformer_feature_size: 1024 px, 768-wide SAM embeddings,
   width 512) on 1 episode of 1-way 1-shot, mask prompts, on the card
   (flash kernel) against the CPU (plain twin), as phase 3; every class of
   the episode is flagged;
13. affinity decode (bf16): 2 episodes of 2-way 1-shot a forward, two
   batches alternating, 1 warm-up and 8 timed forwards: episodes per
   second, peak memory, logits (2, 3, 1024, 1024) finite in the valid
   region of flagged classes with the pad fill and with no finite value
   for a class no example flags, 2 flash launches a forward; a profiler
   pass; the same forwards inside ``plain_attention()``;
14. options parity (fp32): ``lam_b`` with ``fused_window=True`` on the card
   against the CPU and against ``fused_window=False`` on the card, as phase
   3; ``build_vit_h`` with the option (28 K8 launches of 80-wide heads, 4
   packed global) against the same call inside ``plain_attention()``, as
   phase 7; one fp32 training pass of phase 5 with the option against the
   unfused pass, gradients under phase 5's rules;
15. options serving (bf16): ``lam_b`` requests with ``fused_window=True``
   (8 K8 + 4 global launches an encoder call, no windowed kernel; a
   profiler pass) and with ``int8_scores=True`` (4 int8 global + 8
   windowed launches), beside phase 4's, with the int8 logits' argmax
   agreement with phase 4's; ``build_vit_b`` / ``build_vit_l`` /
   ``build_vit_h`` embedding 8 images with ``fused_window`` on (8 / 20 / 28
   K8 launches a call, no windowed kernel) beside off;
16. golden replays (fp32): ``canonical_full_forward`` (``lam_no_vit`` at
   480 px) and ``sam_released_full_forward`` (``lam_b`` at 1024 px, with
   ``fused_window`` off and on) through the port on the card, held to the
   original PyTorch LabelAnything's outputs at the cases' tolerances;
17. flagship training (the JAX ``bench_train``: mae.yaml's ``lam_no_vit``,
   focal loss with class weighting, AdamW 5e-5, 8 episodes of 5-way 1-shot
   a step through ``Substitutor``, ``init_train_state`` and
   ``make_train_step``): one fp32 pass with K7 forced against the same pass
   inside ``plain_attention()`` under phase 5's rules; then 1 warm-up and 8
   timed bf16 steps with masks, without, and with ``shared_keys=True``:
   episodes per second, peak memory, 2 K7 launches a step (1 with shared
   keys), every loss finite, every parameter with a gradient moved; a
   profiler pass;
18. affinity training (4.2_Affinity_SAM.yaml's model block and
   ``train_params``, without ``transformer_feature_size``): one fp32 pass
   through K6 against ``plain_attention()`` under phase 5's rules, a
   parameter's and the whole gradient's allowance widened to 4 x the
   twin's distance from the twin with fp64 scores, and at most 4 x that
   twin's switched ReLU units (units flip at rounding), and the same pass
   with K6 in bf16 refused by those rules; fp32
   steps at every (episodes, ways, shots) of its
   ``possible_batch_example_nums`` with the peak memory of each, K6's
   backward recomputing over blocks of query rows where its scores would
   pass ``RECOMPUTE_BYTES``; bf16 steps at (2, 2, 2): episodes per second,
   2 K6 launches a step;
19. the workflow: ``preprocess_images_to_embeddings`` with ``build_vit_b``
   and ``last_block_dir`` on 16 seeded uint8 images of two sizes, batches
   of 8, after a warm-up batch (images per second, 4 K1 and 8 K2 launches
   a batch; the host's resize and cache writes of one image timed alone);
   the caches read back and held to the encoder's output bit for bit; 4
   fp32 affinity training steps on them, a checkpoint after step 2 restored into
   a fresh state, steps 3 and 4 equal to the straight run's bit for bit;
   ``save_pretrained`` / ``from_pretrained`` and
   ``predict_original_resolution`` at the images' own sizes, the reloaded
   model's logits equal bit for bit;
20. the training entry point: a synthetic COCO root (``data/
   synthetic_coco.py``: MAE_IMAGES images of COCO's sizes with 2 to 6
   polygons each, COCO's 80 category ids, one 768 x 30 x 30 embedding
   cache an image), then ``parameters/trainval/coco20i/mae.yaml`` itself,
   read by the port's YAML reader, its paths pointed at that root, cut to
   one epoch of MAE_STEPS steps and MAE_VAL validation episodes a set, run
   through ``labelanything_tpu_torch.cli run`` on the card (bf16, AdamW
   with warm-up, focal loss, the six batch tuples, all prompt types,
   16 loader threads, N1K1 / N2K1 validation): finite losses, train and
   validation lines in ``metrics.jsonl``, ``checkpoints/latest`` and
   ``best``; per tuple K7's launches a step, instances a launch and
   cluster size, every step launching it and every TwoWayTransformer call
   its rule refuses having more than ``KERNEL_MAX_TOKENS`` tokens; a second
   ``Run`` resumes at epoch 1 with every parameter and AdamW moment equal
   to the checkpoint's; episodes/s from the third step on, the loop's share
   of time waiting on the loader, a batch's time in the loop split into
   its train step (timed between two synchronizations), the loader wait
   and the rest of the loop, peak memory, a profiler pass over 4 steps
   (busy share, kernel time by name) beside phase 17's rate; then the
   same config in fp32 at a constant learning rate for MAE_PARITY_STEPS
   steps on the card (K7 forced) and on the CPU from the same weights:
   each step's loss, the first step's AdamW first moments per parameter,
   the run's first moments and the parameters' change as whole vectors
   (the rules beside MAE_PARITY_STEPS), a control that makes no update
   refused; validation mIoU / FB-IoU within MAE_METRIC_ATOL, the argmax
   agreeing on more than MAE_ARGMAX_AGREE of the pixels;
21. checkpoint evaluation: ``parameters/validation/COCO/mae.yaml``, its
   paths pointed at phase 20's root, refuses phase 20's checkpoint by name
   as it stands (its model block sets ``example_class_attention`` False,
   mae.yaml's True); with the block matched, ``cli validate --checkpoint
   <phase 20's run>/checkpoints`` runs its 4 folds x 4 sets, cut to
   EVAL_RERUNS reruns and EVAL_VAL episodes a set (EVAL_VAL_5SHOT for the
   5-shot sets; fp32): every
   ``fold{i}/<set>_<metric>``, ``mean/miou`` and ``mean/fbiou`` finite,
   the loader threads gone with the folds' ``Run``s; ``--folds 0
   --compare`` (on N1K1 and N2K1 at EVAL_PARITY_VAL episodes): the deltas
   equal result - reference; bf16 on mae.yaml's
   own N1K1 / N2K1 sets with K7's launches counted at both call sites;
   each set's batch time in the CLI run (``Run.val_batch_times``: loader
   wait and loop time; the forward timed between two synchronizations)
   split into loader wait, forward and the rest, a profiler pass over
   N2K5 (busy share); fp32 card against CPU on fold 0's N1K1 and N2K1, 1
   rerun, EVAL_PARITY_VAL episodes: metrics within MAE_METRIC_ATOL, the
   confusion matrices by ``confusions_agree``;
22. PASCAL-5i: a synthetic VOC root (``data/synthetic_voc.py``: VOC_IMAGES
   palette masks of VOC's sizes written by ``data/png.py``, one 768 x 30 x
   30 cache an image), the ms a mask decode, then
   ``parameters/trainval/pascal/mae.yaml`` through ``cli run`` (fp32, one
   epoch of VOC_STEPS steps, VOC_VAL episodes a validation set) and
   ``cli validate --checkpoint`` on the run it wrote (the run's own
   validation numbers again); episodes/s, the loader-wait share; fp32 card
   against CPU: MAE_PARITY_STEPS steps' losses within MAE_LOSS_RTOL, the
   validation metrics within MAE_METRIC_ATOL and its confusion matrices
   by ``confusions_agree``;
23. the COCO test protocol: ``cli test`` on a ``test_coco`` set over
   phase 20's root (80 categories) under mae.yaml's model block (bf16),
   TEST_BATCH queries a call: finite metrics, support-set time, query
   images/s, peak memory, the TwoWayTransformer calls K7's rule refused
   all over its token limit; on TEST_PARITY_QUERIES queries, fp32 card
   against CPU within MAE_METRIC_ATOL and ``confusions_agree``; one
   TEST_LOGIT_QUERIES queries' logits of the fp32 and the bf16 card
   against the fp32 CPU's by TEST_FP32_REL_L2 / TEST_BF16_RATIO, a
   control with the columns rolled refused;
24. image decoding: every committed fixture (``tests/fixtures/images``)
   through the C JPEG decoder (``data/jpeg.py``; the host library of
   ``data/native.py``, built with the system compiler, also unfilters PNG
   rows and resizes) and the TIFF / PNG readers, each against PIL's recorded
   SHA-256 (``pil_decoded.json``), the JPEGs also against the numpy twin
   bit for bit; the C decoder's ms for the 640 x 480 4:2:0 fixture on one
   thread, its images/s on DECODE_THREADS threads, the twin's seconds;
   the PNG unfilter and the resize in C against their numpy twins, and
   ``preprocess.load_one`` with each (``host_loops``);
25. ``cli generate_embeddings`` (``vit_b``, 1024 px, bf16, batches of 8)
   on a synthetic COCO image root (``write_synthetic_coco`` with
   ``image_sources``: EMBED_IMAGES images, the committed COCO-sized JPEGs
   copied, every fourth an RGB PNG), under a profiler pass that counts K1
   and K2 by kernel name (4 and 8 a batch), then again for its images/s;
   one image's cache against the CPU port's fp32 encoder on the same
   decoded frame (relative L2 within EMBED_BF16_REL_L2: the card runs
   bf16); then ``cli generate_gt`` adds every image's ground truth;
26. ``cli run`` of ``trainval/other/COCO_vit.yaml``'s model and train
   blocks (``lam_b`` at 1024 px, fp32 as the file sets no dtype, the
   backbone frozen; ``checkpoint`` and ``use_sam_checkpoint`` taken out:
   no SAM weights here) on phase 25's ``img_dir`` for VIT_STEPS steps:
   every step launches K1 (4) and K2 (8), none launches K3 or K4; images
   a second; the first step's loss of a one-episode batch, card against
   CPU from the same weights, within VIT_LOSS_RTOL;
27. ``cli test`` on synthetic roots of the four cross-domain layouts
   (``data/synthetic_crossdomain.py``: Kvasir's JPEG images and masks,
   WeedMap's PNG channel tiles, Brain MRI's TIFFs, DRAM's JPEGs with
   palette PNG labels) under ``parameters/test/*.yaml`` with ``lam_b`` in
   the model block (the files' ``lam_no_vit`` cannot read images, ROADMAP
   C13), fp32: finite metrics, K1 and K2 launched; Kvasir's card against
   CPU within MAE_METRIC_ATOL and ``confusions_agree``;
28. the baselines (``phase_baselines``): ``cli validate`` of
   ``validation/COCO/bam_1shot.yaml`` (N1K1), the N5K1 set of
   ``hdmnet_N5-10-15-20.yaml``, ``panet.yaml`` (N1K1, N2K1) on phase 25's
   image root, ``validation/Pascal/ppnet.yaml`` and ``denet.yaml`` with a
   ``data_dir`` (C12) on a VOC root of BASELINE_VOC_IMAGES JPEGs, at the
   files' full width, fp32, seeded weights, 1 rerun, BASELINE_VAL episodes
   a set: finite metrics, episodes/s, the loader-wait share, peak memory,
   a profiler pass over a set (busy share), no kernel launch; one batch each, card against CPU
   (``baseline_logits_agree``: rtol 1e-3 / atol 5e-4 on the flagged
   classes, argmax above BASELINE_ARGMAX_AGREE); the golden fixtures
   ``ppnet_full``, ``denet_2way_2shot``, ``bam_1shot`` and
   ``hdmnet_1shot`` on the card at their cases' tolerances;
29. DCAMA (Swin-B) and FPTrans through ``cli validate``, DCAMA's SGD recipe
   through ``cli run`` (``phase_swin_vit_baselines``);
30. the LAM variants (``phase_lam_variants``): every distinct model block
   of the 15 trainval files of VARIANT_TRAIN (OneWay / Identity fusion,
   ``class_embedding_dim`` with Affinity and PrototypeAffinity, the
   pooler, several embeddings an example, TokenPool, two classification
   levels, ``conv_classification``, dropout 0.2 and 0.5) at its own
   ``image_size``, ``image_embed_dim`` and ``embed_dim`` through ``Run``
   (VARIANT_STEPS steps at VARIANT_TUPLE, VARIANT_VAL validation episodes
   a set) on phase 20's and phase 22's 480-px roots and on 1024-px roots
   of 64 x 64 caches, 4.3_AFClass_SAM without its
   ``transformer_feature_size`` (C3): finite losses and metrics, steps/s,
   peak memory, the first step's loss card against CPU in fp32 within
   VARIANT_LOSS_RTOL (not where the step draws dropout masks: the card's
   and the CPU's generators differ), one validation batch's fp32 logits
   card against CPU (``variant_logits_agree``: the argmax equal wherever
   the tolerance cannot swap the two largest logits), a card dropout mask's
   keep rate within 5 binomial standard deviations; K6 launched in
   4.3_AFClass_SAM's model, K7 counted by call site in the bf16
   ``coco20i/mae_pool.yaml``, no launch in the other fp32 files; then
   the 4 validation files of VARIANT_VALIDATE through ``cli validate
   --checkpoint --folds i``, each grid point from the checkpoint of a
   run of its model block (a run of its own on VARIANT_EXTRA_FROM's
   set-up where no trainval file has the block), with a ``data_dir``
   (C12).

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. The models are the repo's LAM
configuration (parameters/trainval/other/COCO_vit.yaml) with the SAM ViT-B,
ViT-L and ViT-H encoders at full width and depth, with random weights from
a seed (``utils.weights.init_weights``).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from labelanything_tpu_torch.api import LabelAnything
from labelanything_tpu_torch.data.synthetic import (flag_every_class,
                                                    random_batch,
                                                    random_full_batch)
from labelanything_tpu_torch.models.build_encoder import (build_vit_b,
                                                          build_vit_h,
                                                          build_vit_l)
from labelanything_tpu_torch.models.build_lam import build_lam
from labelanything_tpu_torch.models.common import MLPBlock
from labelanything_tpu_torch.models.image_encoder import ImageEncoderViT
from labelanything_tpu_torch.models.mask_decoder import MLP
from labelanything_tpu_torch.models.transformer import TwoWayTransformer
from labelanything_tpu_torch.ops import _build
from labelanything_tpu_torch.ops import flash_attention as fa
from labelanything_tpu_torch.ops import fused_twoway as ft
from labelanything_tpu_torch.ops import fused_window as fw
from labelanything_tpu_torch.ops import microbench_softmax_dtype as microbench
from labelanything_tpu_torch.ops import time_kernels
from labelanything_tpu_torch.ops.time_kernels import unfused_window_call
from labelanything_tpu_torch.parallel.train_step import (init_train_state,
                                                         make_train_step)
from labelanything_tpu_torch.train.losses import LabelAnythingLoss
from labelanything_tpu_torch.train.substitutor import Substitutor
from labelanything_tpu_torch.data.transforms import get_preprocess_shape
from labelanything_tpu_torch.typing import IGNORE_INDEX, BatchKeys, ResultDict
from labelanything_tpu_torch.utils.weights import init_weights
from tests.golden import CASES
from tests.torch_golden_replay import replay

# the model block of parameters/trainval/other/COCO_vit.yaml
CONFIG = dict(name="lam_b", spatial_convs=3, class_attention=False,
              example_attention=True, example_class_attention=False,
              fusion_transformer="TwoWayTransformer", image_embed_dim=768,
              embed_dim=512, image_size=1024, use_vit_sam_neck=False,
              class_encoder={"name": "RandomMatrixEncoder", "bank_size": 100,
                             "embed_dim": 512})
# the same block with the SAM ViT-H and ViT-L encoders
CONFIG_H = dict(CONFIG, name="lam_h", image_embed_dim=1280)
CONFIG_L = dict(CONFIG, name="lam_l", image_embed_dim=1024)
# the model block of parameters/trainval/coco20i/mae.yaml
CONFIG_DECODE = dict(name="lam_no_vit", spatial_convs=3, class_attention=False,
                     example_attention=False, example_class_attention=True,
                     fusion_transformer="TwoWayTransformer",
                     image_embed_dim=768, embed_dim=256, image_size=480,
                     class_encoder={"name": "RandomMatrixEncoder",
                                    "bank_size": 100, "embed_dim": 256})
# bench_decode's episodes: 16 of 5-way 1-shot; the prompt encoder's fusion
# then runs 16 x 1 x 6 instances, the mask decoder's 16, each of 30 x 30
# image tokens against 6 tokens
DECODE_BATCH, DECODE_CLASSES, DECODE_STEPS = 16, 6, 8
# the model block of parameters/trainval/other/Affinity/4.2_Affinity_SAM.yaml
# (the first class_fusion of its grid) without transformer_feature_size,
# with which the JAX package cannot run (ROADMAP C3); the transformer then
# works at the embeddings' 64 x 64 grid
CONFIG_AFFINITY = dict(name="lam_no_vit", few_type="Affinity",
                       spatial_convs=3, class_attention=True,
                       example_attention=True, image_embed_dim=768,
                       embed_dim=512, image_size=1024, class_fusion="mul",
                       transformer_keys_are_images=True,
                       decoder_attention_downsample_rate=2,
                       class_encoder={"name": "RandomMatrixEncoder",
                                      "bank_size": 100, "embed_dim": 512})
# its val_coco20i_N2K1 at the configuration's validation batch: 2 episodes
# of 2-way 1-shot (2 support images, 3 classes with the background)
AFFINITY_BATCH, AFFINITY_SHOTS, AFFINITY_CLASSES, AFFINITY_STEPS = 2, 2, 3, 8
AFFINITY_LAUNCHES = {"flash": 2}   # a forward: the transformer's 2 blocks
DECODE_LAUNCHES = {"fused_twoway": 2}   # a forward: both transformers
TWOWAY = dict(name="fused_twoway", s=900, n=6, d=256, heads=8, mlp=2048,
              depth=2, inner=128,
              source="labelanything_tpu_torch/csrc/fused_twoway.cu",
              replaces="labelanything_tpu/ops/fused_twoway.py:289")
# phase 17 (training, bench_train's 8 episodes of 5-way 1-shot) launches
# it at 8 x 6 and 8 instances
TWOWAY_SITES = {"prompt_encoder": DECODE_BATCH * DECODE_CLASSES,
                "mask_decoder": DECODE_BATCH,
                "train_prompt_encoder": 8 * DECODE_CLASSES,
                "train_mask_decoder": 8}
SEED = 0
HEADS = 12
SCALE = 64 ** -0.5
# kernel launches of one encoder call: 4 global and 8 windowed blocks
ENCODER_LAUNCHES = {"relpos_global": 4, "relpos_window": 8}
# ViT-H: 4 global and 28 windowed blocks, heads 80 wide, the packed kernels;
# ViT-L: 4 and 20 blocks, heads 64 wide, the lanes kernels
ENCODER_LAUNCHES_H = {"relpos_packed_global": 4, "relpos_packed_window": 28}
ENCODER_LAUNCHES_L = {"relpos_global": 4, "relpos_window": 20}
HEADS_H, DH_H = 16, 80
EMBED_BATCH = 8
TRAIN_LAUNCHES = {"relpos_global": 4, "relpos_window": 8,
                  "relpos_global_bwd": 4, "relpos_window_bwd": 8}
TRAIN_STEPS = 4
FP32_STEPS = 5
LEARNING_RATE = 5e-5
# phase 5: |g_kernel - g_plain|_2 <= GRAD_REL_L2 * |g_plain|_2 per parameter
# (fp32 on both sides; the kernels and the plain twins sum in other orders)
GRAD_REL_L2 = 2e-4
GRAD_FLOOR = 1e-4
# phase 5, the bf16 pass against the fp32 one on the same episode: bf16
# rounds every activation of 12 blocks and two transformers, so the loss
# agrees to a few 1e-3 and the whole gradient's direction to a cosine of
# about 0.93 with these weights
BF16_LOSS_RTOL = 5e-3
BF16_GRAD_COSINE = 0.85
# published peaks of the H100 SXM: dense bf16 tensor-core rate, memory rate
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# exponentials an SM starts a clock on its special-function units (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0); the card's SM count and maximum SM clock are read in the run
EXP_PER_CLOCK_SM = 16
_SRC = "labelanything_tpu_torch/csrc/"
_JAX = "labelanything_tpu/ops/flash_attention.py:"
KERNELS = [
    dict(name="relpos_global", fn=fa.flash_attention_relpos_lanes, b=1,
         grid=(64, 64), backward=False, source=_SRC + "relpos_packed_sm90.cu",
         replaces=_JAX + "1318"),
    dict(name="relpos_window", fn=fa.flash_attention_relpos_lanes_batched,
         b=25, grid=(14, 14), backward=False,
         source=_SRC + "relpos_window.cu", replaces=_JAX + "881"),
    dict(name="relpos_global_bwd", fn=fa.flash_attention_relpos_lanes, b=6,
         grid=(64, 64), backward=True, source=_SRC + "relpos_global_bwd.cu",
         replaces=_JAX + "1343"),
    dict(name="relpos_window_bwd", fn=fa.flash_attention_relpos_lanes_batched,
         b=150, grid=(14, 14), backward=True,
         source=_SRC + "relpos_window_bwd.cu", replaces=_JAX + "901"),
]
# K1 besides a request's image with ViT-B's 12 heads: ViT-L's 16 heads,
# the training step's 6 images (the log-sum-exp written) and the embedding
# batch of 8 images; every shape is held on out and log-sum-exp, the
# timed ones are timed as their path launches them (with the log-sum-exp
# at the step's shape, without at the others)
GLOBAL_MORE = {"vit_l_heads16": dict(KERNELS[0], heads=16, timed=False),
               "b6_lse": dict(KERNELS[0], b=6, lse=True, timed=True),
               "b6_heads16_lse": dict(KERNELS[0], b=6, heads=16, lse=True,
                                      timed=True),
               "b8": dict(KERNELS[0], b=8, timed=True),
               "b8_heads16": dict(KERNELS[0], b=8, heads=16, timed=True)}
# |lse - twin's lse| <= LSE_TOL (1 + |twin's lse|): the kernel sums in
# fp32 over 4096 keys what the twin sums in fp64
LSE_TOL = 1e-4
# K2 besides the request's 25 windows: the embedding batch (8 images, 200
# windows) and ViT-L's 16 heads; timed and held against the twins
WINDOW_MORE = {"b200": dict(KERNELS[1], b=200),
               "vit_l_heads16": dict(KERNELS[1], heads=16)}
# the packed kernels at ViT-H's serving shapes: one image, 25 windows
PACKED_KERNELS = [
    dict(name="relpos_packed_global", b=1, grid=(64, 64), heads=HEADS_H,
         dh=DH_H, backward=False, source=_SRC + "relpos_packed_sm90.cu",
         replaces=_JAX + "1371"),
    dict(name="relpos_packed_window", b=25, grid=(14, 14), heads=HEADS_H,
         dh=DH_H, backward=False, source=_SRC + "relpos_packed.cu",
         replaces=_JAX + "1371"),
]
# the packed kernels besides a request's image: the embedding batch (8
# images: the global kernel's 8, the windowed kernel's 200 windows); timed
# and held against the twins
PACKED_MORE = {"b200": dict(PACKED_KERNELS[1], b=200),
               "b8": dict(PACKED_KERNELS[0], b=8)}
# the microbench's variants of the packed global kernel, at the same shape
VARIANT_KERNELS = [
    dict(PACKED_KERNELS[0], name=kernel,
         source=_SRC + "relpos_packed_variants.cu",
         replaces="scripts/microbench_softmax_dtype.py:113", variant=mode)
    for mode, kernel in microbench.VARIANTS.items() if mode != "e"]
# the plain flash kernel (K6) at the affinity decoder's call on phase 13's
# traffic: 2 episodes x 3 classes, 8 heads, 4096 query tokens against 2
# support images' 8192, 32 wide; then a ragged length (the JAX test's 1152)
# and the route's other head widths on a small batch, not timed: 64 on the
# Hopper kernel, 128 and 256 on the mma.sync kernel (flash_attention.cu)
FLASH = dict(name="flash", b=6, heads=8, nq=4096, nk=8192, dh=32,
             source=_SRC + "flash_wgmma.cu",
             replaces="labelanything_tpu/ops/flash_attention.py:367")
FLASH_OTHER = [dict(FLASH, b=1, heads=2, nq=1152, nk=1152),
               dict(FLASH, b=2, heads=2, nq=1024, nk=2048, dh=64),
               dict(FLASH, b=1, heads=2, nq=1152, nk=1024, dh=128),
               dict(FLASH, b=1, heads=2, nq=1024, nk=1152, dh=256)]
# The global kernels' general bias path: a key grid whose rows are not 64
# wide (a 768-px image) at the training step's batch. Held against the
# plain twins, not timed; the main path at 1024 px does not take it.
GENERAL_PATH = [dict(KERNELS[0], b=6, grid=(48, 48)),
                dict(KERNELS[2], grid=(48, 48))]
PACKED_GENERAL_PATH = dict(PACKED_KERNELS[0], b=2, grid=(48, 48),
                           source=_SRC + "relpos_packed.cu")
# parameters that the step's episodes give no gradient: negative points,
# the no-mask / no-sparse stand-ins, and the prompt transformer's final
# token-to-image attention, whose output (the queries) the encoder drops
NO_GRADIENT = ("prompt_encoder.point_embeddings.0.",
               "prompt_encoder.no_mask_embed.",
               "prompt_encoder.no_sparse_embedding.",
               "prompt_encoder.transformer.final_attn_token_to_image.",
               "prompt_encoder.transformer.norm_final_attn.")
# a bias added to every key shifts all scores of a query alike, which the
# softmax ignores, and so does the class MLP's last bias, added to every
# class embedding (every class logit of a pixel moves alike): their
# gradients are zero up to rounding and may not move them
ZERO_GRADIENT = ("k_proj.bias", "class_mlp.layers.2.bias")
# the fused windowed block (K8) at one 1024-px image's windowed block:
# 25 windows of 14 x 14, 64 x 64 padded to 70 x 70; ViT-B, then ViT-H
FUSED_WINDOW = dict(name="fused_window", b=1, hp=70, ws=14, heads=HEADS,
                    dh=64, source=_SRC + "fused_window.cu",
                    replaces="labelanything_tpu/ops/fused_window.py:236")
FUSED_WINDOW_H = dict(FUSED_WINDOW, heads=HEADS_H, dh=DH_H)
# the int8 score branch of the global kernel at ViT-B's global block
INT8 = dict(KERNELS[0], name="relpos_global_int8",
            source=_SRC + "relpos_global_int8.cu", replaces=_JAX + "170")
# tensor-core rate of int8 products (H100 SXM, dense)
PEAK_INT8_OPS = 1979e12
# launches of one encoder call with the options: every windowed block takes
# K8 (ViT-B 8, ViT-L 20, ViT-H 28), the global blocks their usual kernel;
# with int8 scores the 64-wide global blocks take the int8 kernel
FUSED_LAUNCHES = {"relpos_global": 4, "fused_window": 8}
FUSED_LAUNCHES_L = {"relpos_global": 4, "fused_window": 20}
FUSED_LAUNCHES_H = {"relpos_packed_global": 4, "fused_window": 28}
INT8_LAUNCHES = {"relpos_global_int8": 4, "relpos_window": 8}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def median_ms(fn, iters: int = 20) -> float:
    """Median of per-call CUDA-event times after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# cycles of the card's spin kernel that timed launches queue behind: some
# 100 ms at 1.98 GHz, longer than the host takes to enqueue them
SPIN_CYCLES = 2 * 10 ** 8


def device_ms(fn, launches: int = 200) -> float:
    """Device time per launch, as ``ops/time_kernels.py`` takes it:
    ``launches`` back-to-back calls between two CUDA events after a
    warm-up, the median of three such runs. The calls are enqueued while the
    card spins (``torch.cuda._sleep``) ahead of the first event, so they
    run back to back whatever the host's time a call: this is the card's
    time, where :func:`median_ms` (an event pair around each call) also
    holds the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / launches)
    return statistics.median(runs)


def ratio_text(s: dict) -> str:
    """A kernel's times over its library call's: per wrapper call and on
    the device."""
    return (f"ratio to the library call {s['ms'] / s['library_ms']:.3f} a "
            f"call, {s['device_ms'] / s['library_device_ms']:.3f} on the "
            f"device ({s['device_ms']:.4f} ms vs {s['library_device_ms']:.4f} "
            f"ms)")


def share_text(s: dict) -> str:
    """A kernel's share of its bound: the least time the card could take
    over its device time."""
    return (f"share of the bound {s['bound_ms'] / s['device_ms']:.3f} on the "
            f"device")


def phase_card() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    print(_build.build_log.strip())


def bound(k: dict) -> dict:
    """Least time the card could take for one call of kernel ``k`` in bf16:
    the larger of operations / peak rate and bytes / memory rate, every
    input read once and every output written once. Forward: the q.k^T and
    P.v products, 4 N^2 dh flops per head; inputs qkv, r; output out.
    Backward: five such products (dP, dQ, dK, dV and the recomputed
    scores), 10 N^2 dh; inputs qkv, r, out, dout and the forward's
    log-sum-exp (fp32); outputs dqkv, dr."""
    kh, kw = k["grid"]
    heads, dh = k.get("heads", HEADS), k.get("dh", 64)
    b, n, c = k["b"], kh * kw, heads * dh
    r_width = heads * (kh + kw)
    if k["backward"]:
        flops = 10 * b * heads * n * n * dh
        nbytes = 2 * b * n * (2 * 3 * c + 2 * r_width + 2 * c) \
            + 4 * b * heads * n
    else:
        flops = 4 * b * heads * n * n * dh
        nbytes = 2 * b * n * (3 * c + r_width + c)
    if k.get("lse"):
        nbytes += 4 * b * heads * n
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def library_attention(qkv, r, grid_hw):
    """The same function through one library call: the factored bias
    expanded to (B, H, N, N), then ``scaled_dot_product_attention``."""
    b, n, c3 = qkv.shape
    kh, kw = grid_hw
    c, heads = c3 // 3, r.shape[-1] // (kh + kw)
    q, k, v = (x.reshape(b, n, heads, 64).transpose(1, 2)
               for x in qkv.split(c, dim=-1))
    rb = r.reshape(b, n, heads, kh + kw).transpose(1, 2) / fa.LOG2E
    bias = (rb[..., :kh, None] + rb[..., None, kh:]).reshape(b, heads, n, n)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=SCALE)
    return out.transpose(1, 2).reshape(b, n, c)


def library_attention_packed(qkv, r, grid_hw):
    """:func:`library_attention` on the packed layout."""
    kh, kw = grid_hw
    heads = r.shape[1]
    rb = r / fa.LOG2E
    bias = (rb[..., :kh, None] + rb[..., None, kh:]).reshape(
        *r.shape[:3], kh * kw)
    return F.scaled_dot_product_attention(
        qkv[:, :heads], qkv[:, heads:2 * heads], qkv[:, 2 * heads:],
        attn_mask=bias, scale=qkv.shape[-1] ** -0.5)


def kernel_args(k: dict) -> tuple:
    return (k.get("dh", 64) ** -0.5, k["grid"], k.get("heads", HEADS))


def packed_inputs(k: dict):
    """fp32 inputs of a packed kernel as the encoder hands them over: the
    qkv projection (B, N, 3 C) viewed (B, 3 heads, N, dh) and r (B, N,
    heads, kh + kw) viewed (B, heads, N, kh + kw), neither copied; and a
    cotangent (B, heads, N, dh)."""
    kh, kw = k["grid"]
    b, n, heads, dh = k["b"], kh * kw, k["heads"], k["dh"]
    rng = np.random.default_rng(1)
    proj = torch.from_numpy(rng.standard_normal((b, n, 3 * heads * dh),
                                                np.float32)).cuda()
    r = torch.from_numpy((0.5 * rng.standard_normal(
        (b, n, heads, kh + kw))).astype(np.float32)).cuda()
    ct = torch.from_numpy(rng.standard_normal((b, heads, n, dh),
                                              np.float32)).cuda()
    return (proj.view(b, n, 3 * heads, dh).permute(0, 2, 1, 3),
            r.permute(0, 2, 1, 3), ct)


def kernel_inputs(k: dict):
    if "dh" in k:
        return packed_inputs(k)
    kh, kw = k["grid"]
    heads = k.get("heads", HEADS)
    n, c = kh * kw, heads * 64
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((k["b"], n, 3 * c),
                                               np.float32)).cuda()
    r = torch.from_numpy((0.5 * rng.standard_normal(
        (k["b"], n, heads * (kh + kw)))).astype(np.float32)).cuda()
    ct = torch.from_numpy(rng.standard_normal((k["b"], n, c),
                                              np.float32)).cuda()
    return qkv, r, ct


def layout(k: dict) -> dict:
    """Wrapper, plain twin and library call of a kernel's layout: packed
    for the kernels that name a head width, else token-major."""
    if "dh" in k:
        return dict(fn=fa.flash_attention_relpos_packed,
                    plain=fa.relpos_packed_plain,
                    library=library_attention_packed)
    return dict(fn=k["fn"], plain=fa.relpos_attention_plain,
                library=library_attention)


@torch.no_grad()
def forward_error(k: dict, out, qkv, r) -> tuple:
    """Holds a forward kernel's ``out`` against the plain twin on the same
    inputs: (worst error, bf16 floor or None)."""
    args = kernel_args(k)
    plain = layout(k)["plain"]
    ref = plain(qkv, r, *args)
    torch.cuda.synchronize()
    check(out.dtype == qkv.dtype, f"{k['name']}: output is {out.dtype}")
    if qkv.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        return (out - ref).abs().max().item(), None
    ref32 = plain(qkv.float(), r.float(), *args)
    err = (out.float() - ref.float()).abs().max().item()
    floor = (ref.float() - ref32).abs().max().item()
    check(err <= 4 * floor + 1e-6,
          f"{k['name']} b {k['b']} bf16 forward error {err} > 4 x floor "
          f"{floor}")
    return err, floor


def check_forward(k: dict, timed: bool = True) -> dict:
    qkv, r, _ = kernel_inputs(k)
    args = kernel_args(k)
    fn, plain, library = (layout(k)[x] for x in ("fn", "plain", "library"))
    err32, _ = forward_error(k, fn(qkv, r, *args), qkv, r)
    qb, rb = qkv.bfloat16(), r.bfloat16()
    err16, floor = forward_error(k, fn(qb, rb, *args), qb, rb)
    stats = dict(max_abs_err=err32, max_abs_err_bf16=err16, bf16_floor=floor)
    if not timed:
        return stats
    ref_b32 = plain(qb.float(), rb.float(), *args)
    lib = library(qb, rb, k["grid"])
    check((lib.float() - ref_b32).abs().max().item() <= 4 * floor + 1e-6,
          f"{k['name']}: the library call computes another function")
    del ref_b32, lib
    return dict(
        stats,
        ms=median_ms(lambda: fn(qb, rb, *args)),
        plain_ms=median_ms(lambda: plain(qb, rb, *args)),
        library_ms=median_ms(lambda: library(qb, rb, k["grid"])),
        device_ms=device_ms(lambda: fn(qb, rb, *args)),
        library_device_ms=device_ms(lambda: library(qb, rb, k["grid"])),
        ms_fp32=median_ms(lambda: fn(qkv, r, *args)),
        plain_ms_fp32=median_ms(lambda: plain(qkv, r, *args)),
        device_ms_fp32=device_ms(lambda: fn(qkv, r, *args), 50),
        plain_device_ms_fp32=device_ms(lambda: plain(qkv, r, *args), 20))


def check_global_route(k: dict) -> tuple:
    """The lanes global route in bf16 launches the kernel that
    ``global_kernel`` names for ``k``'s grid, and no other, over 20 calls
    of a profiler pass; returns that kernel's name and the launches the
    pass saw, which must be all 20 (``time_kernels.kernel_events``)."""
    qkv, r, _ = kernel_inputs(k)
    qb, rb = qkv.bfloat16(), r.bfloat16()
    with torch.no_grad():
        names = time_kernels.kernel_names(
            lambda: k["fn"](qb, rb, *kernel_args(k)))
    want = fa.global_kernel(torch.bfloat16, k["grid"])
    check(len(names) == 1 and want in next(iter(names))
          and next(iter(names.values())) == 20,
          f"{k['name']} b {k['b']} grid {k['grid']}: 20 calls launched "
          f"{names}, its rule names {want}")
    return want, next(iter(names.values()))


def audit_launches() -> None:
    """The wgmma kernels' launches counted three ways (ROADMAP C8): 20
    calls of K1 and of K5 global on distinct inputs, each output written
    into a NaN block and held to the twin; each call's launch counted by
    ``LAUNCHES``, timed by a CUDA event pair, and found by three profiler
    passes (``time_kernels.profile_pass``) that must see all 20; K3's three
    kernels by name in three passes likewise. Each pass also shows how many
    of its guard's sentinel records the profiler dropped."""
    guard = time_kernels.GUARD_SENTINELS + 1
    for name, rec in time_kernels.audit_global_kernels().items():
        if name == "relpos_global_bwd":
            passes = rec["passes"]
            check(all(len(p["counts"]) == 3
                      and set(p["counts"].values()) == {rec["calls"]}
                      for p in passes), f"audit {name}: passes saw {passes}")
            print(f"audit {name}: {rec['calls']} calls a pass; "
                  f"{len(passes)} passes saw each of its 3 kernels "
                  f"{rec['calls']} times, dropping "
                  f"{[guard - p['sentinels'] for p in passes]} of {guard} "
                  f"sentinel records")
            continue
        runs = [rec["events"]] + rec["profiler"]
        for run in runs:
            times = run["event_ms"]
            check(run["launches"] == rec["calls"]
                  and run["nan_prefilled"] == rec["calls"]
                  and min(times) > 0.5 * statistics.median(times),
                  f"audit {name}: {run}")
        seen = [r["profiler_seen"] for r in rec["profiler"]]
        check(set(seen) == {rec["calls"]}, f"audit {name}: profiler passes "
              f"saw {seen} of {rec['calls']} launches")
        print(f"audit {name} ({rec['kernel']}): {len(runs)} passes of "
              f"{rec['calls']} calls on distinct inputs, every output "
              f"written into a NaN block and within "
              f"{max(r['max_abs_err'] for r in runs):.3g} of the twin, "
              f"LAUNCHES {rec['calls']} and {rec['calls']} event-timed "
              f"launches a pass (median "
              f"{statistics.median(rec['events']['event_ms']):.4f} ms); "
              f"profiler records {seen} (sentinel records dropped "
              f"{[guard - r['sentinels_seen'] for r in rec['profiler']]} "
              f"of {guard}; each call also launches a NaN fill)")
    print(f"audit: profiler passes made again for a lost guard so far: "
          f"{time_kernels.guard_overruns}")


def check_global(k: dict) -> dict:
    """K1 in bf16 at one of its paths' shapes: out under the bf16 rule and
    the log-sum-exp against the twin's (:data:`LSE_TOL`), both from one
    launch that writes it; the launch without it gives the same out bits.
    Where ``k`` is timed: the kernel as its path launches it (with the
    log-sum-exp where ``k['lse']``), the twin and the library call, per
    call and on the device."""
    qkv, r, _ = kernel_inputs(k)
    qb, rb = qkv.bfloat16(), r.bfloat16()
    del qkv, r
    args = kernel_args(k)
    with torch.no_grad():
        out, lse = fa._launch("relpos_global", qb, rb, *args, want_lse=True)
        err, floor = forward_error(k, out, qb, rb)
        ref = fa.relpos_lse_plain(qb, rb, *args)
        lse_err = ((lse - ref).abs() / (1 + ref.abs())).max().item()
        check(lse_err <= LSE_TOL, f"{k['name']} b {k['b']} heads "
              f"{k.get('heads', HEADS)}: log-sum-exp error {lse_err} > "
              f"{LSE_TOL}")
        check(torch.equal(k["fn"](qb, rb, *args), out),
              f"{k['name']} b {k['b']}: the launch without the log-sum-exp "
              f"gives other bits")
        del ref, lse
    stats = dict(max_abs_err_bf16=err, bf16_floor=floor,
                 lse_max_rel_err=lse_err, **bound(k))
    if not k.get("timed"):
        return stats
    if k.get("lse"):
        call = lambda: fa._launch("relpos_global", qb, rb, *args,
                                  want_lse=True)
    else:
        call = lambda: k["fn"](qb, rb, *args)
    with torch.no_grad():
        stats.update(
            ms=median_ms(call), device_ms=device_ms(call),
            plain_ms=median_ms(lambda: fa.relpos_attention_plain(qb, rb,
                                                                 *args),
                               iters=5),
            library_ms=median_ms(lambda: library_attention(qb, rb, k["grid"]),
                                 iters=5),
            library_device_ms=device_ms(
                lambda: library_attention(qb, rb, k["grid"]), 20))
    return stats


def check_packed_layouts(k: dict, gradient: bool = True) -> dict:
    """A packed kernel beyond its forward check: the token-major view
    against the contiguous slot-major tensor, bit for bit in both dtypes
    (the output then lies as the input does); in bf16 the call launches
    the kernel that ``packed_global_kernel`` (global) names; and, with
    ``gradient``, a gradient through the autograd function (kernel forward,
    plain backward) against autograd through the plain twin (fp32, rtol =
    atol = 1e-4)."""
    qkv, r, ct = kernel_inputs(k)
    args = kernel_args(k)
    if k["name"] == "relpos_packed_global":
        qb, rb = qkv.bfloat16(), r.bfloat16()
        with torch.no_grad():
            names = time_kernels.kernel_names(
                lambda: fa.flash_attention_relpos_packed(qb, rb, *args))
        want = fa.packed_global_kernel(torch.bfloat16, k["dh"], k["grid"])
        check(len(names) == 1 and want in next(iter(names))
              and next(iter(names.values())) == 20,
              f"{k['name']} b {k['b']} grid {k['grid']}: 20 calls launched "
              f"{names}, its rule names {want}")
        del qb, rb
    if not gradient:
        for a, c in ((qkv, r), (qkv.bfloat16(), r.bfloat16())):
            with torch.no_grad():
                check(torch.equal(
                    fa.flash_attention_relpos_packed(a, c, *args),
                    fa.flash_attention_relpos_packed(
                        a.contiguous(), c.contiguous(), *args)),
                    f"{k['name']} b {k['b']} {a.dtype}: the strided view and "
                    f"the contiguous tensor give other bits")
        return {}
    for a, c in ((qkv, r), (qkv.bfloat16(), r.bfloat16())):
        with torch.no_grad():
            strided = fa.flash_attention_relpos_packed(a, c, *args)
            dense = fa.flash_attention_relpos_packed(
                a.contiguous(), c.contiguous(), *args)
        check(not a.is_contiguous() and dense.is_contiguous()
              and strided.permute(0, 2, 1, 3).is_contiguous(),
              f"{k['name']}: unexpected layouts")
        check(torch.equal(strided, dense),
              f"{k['name']} {a.dtype}: the strided view and the contiguous "
              f"tensor give other bits")
    grads = []
    for fn in (fa.flash_attention_relpos_packed, fa.relpos_packed_plain):
        a, c = qkv.detach().requires_grad_(), r.detach().requires_grad_()
        before = fa.LAUNCHES[k["name"]]
        grads.append(torch.autograd.grad(fn(a, c, *args), (a, c), ct))
        check(fa.LAUNCHES[k["name"]] - before
              == int(fn is fa.flash_attention_relpos_packed),
              f"{k['name']}: launches of the gradient check")
    torch.cuda.synchronize()
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    return dict(grad_max_abs_err=max((g - x).abs().max().item()
                                     for g, x in zip(*grads)))


def check_variants() -> dict:
    """The score-dtype microbench once at batch 1 (both of its shapes): it
    holds each variant of the packed global kernel against the plain twin
    and times it; the plain twin and the library call are timed here on
    its ViT-H inputs. Returns the variants' records for the summary."""
    fa.reset_launches()
    records = microbench.run(batch=1, launches=50, repeats=3)
    launches = dict(fa.LAUNCHES)
    k = VARIANT_KERNELS[0]
    qkv, r = microbench.inputs(1, k["heads"], k["dh"])
    args = kernel_args(k)
    with torch.no_grad():
        plain_ms = median_ms(lambda: fa.relpos_packed_plain(qkv, r, *args))
        library_ms = median_ms(
            lambda: library_attention_packed(qkv, r, k["grid"]))
        library_device = device_ms(
            lambda: library_attention_packed(qkv, r, k["grid"]))
    out = {}
    for k in VARIANT_KERNELS:
        rec = next(x for x in records
                   if x["kernel"] == k["name"] and x["dh"] == k["dh"])
        check(launches[k["name"]] > 0, f"{k['name']} was not launched")
        # the microbench's time is already the device's per launch
        out[k["name"]] = dict(
            max_abs_err=rec["max_abs_err"], bf16_floor=rec["bf16_floor"],
            ms=rec["ms_per_launch"], plain_ms=plain_ms,
            library_ms=library_ms, device_ms=rec["ms_per_launch"],
            library_device_ms=library_device, launches=launches[k["name"]],
            **bound(k))
    return out


def check_backward(k: dict, timed: bool = True) -> dict:
    args = (SCALE, k["grid"], HEADS)
    stats = {}
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv, r, ct = (x.to(dtype) for x in kernel_inputs(k))
        qkv.requires_grad_()
        r.requires_grad_()
        # the forward kernel as training runs it: at this batch, writing
        # the log-sum-exp; its result feeds both backwards below, so it is
        # held against the plain forward first
        out = k["fn"](qkv, r, *args)
        err, _ = forward_error(k, out.detach(), qkv.detach(), r.detach())
        stats["fwd_max_abs_err" + ("" if dtype == torch.float32
                                   else "_bf16")] = err

        def kernel():
            return torch.autograd.grad(out, (qkv, r), ct, retain_graph=True)

        def plain():
            with torch.no_grad():
                return fa.relpos_attention_bwd_plain(qkv, r, out, ct, *args)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if dtype == torch.float32:
            for g, x in zip(got, ref):
                torch.testing.assert_close(g, x, rtol=1e-4, atol=1e-4)
            stats["max_abs_err"] = max((g - x).abs().max().item()
                                       for g, x in zip(got, ref))
            if timed:
                stats["ms_fp32"] = median_ms(kernel, iters=5)
                stats["plain_ms_fp32"] = median_ms(plain, iters=5)
        else:
            with torch.no_grad():
                ref32 = fa.relpos_attention_bwd_plain(
                    qkv.float(), r.float(), out.float(), ct.float(), *args)
            for name, g, x, x32 in zip(("dqkv", "dr"), got, ref, ref32):
                err = (g.float() - x.float()).abs().max().item()
                floor = (x.float() - x32).abs().max().item()
                check(g.dtype == torch.bfloat16 and err <= 4 * floor + 1e-6,
                      f"{k['name']} bf16 {name} error {err} > 4 x floor "
                      f"{floor}")
                worst[name] = (err, floor)
            del ref32
            stats["max_abs_err_bf16"] = max(e for e, _ in worst.values())
            stats["bf16_floor"] = max(f for _, f in worst.values())
            del got, ref
            if timed:
                stats["ms"] = median_ms(kernel, iters=10)
                stats["plain_ms"] = median_ms(plain, iters=5)

                def library():
                    a = qkv.detach().requires_grad_()
                    c = r.detach().requires_grad_()
                    y = library_attention(a, c, k["grid"])
                    return y, torch.autograd.grad(y, (a, c), ct)

                y, lib = library()
                check((y - out).abs().max().item() <= 0.05
                      and all(torch.isfinite(g).all() for g in lib),
                      f"{k['name']}: the library call computes another "
                      f"function")
                del y, lib
                stats["library_ms"] = median_ms(library, iters=5)
                stats["device_ms"] = device_ms(kernel, 20)
                stats["library_device_ms"] = device_ms(library, 10)
                stats["library_fwd_ms"] = median_ms(
                    lambda: library_attention(qkv.detach(), r.detach(),
                                              k["grid"]), iters=5)
                stats.update(bwd_parts_ms(kernel, bwd_parts(k)))
            # no atomics: a second run gives the same bits
            again = kernel()
            check(all(torch.equal(a, g) for a, g in zip(again, kernel())),
                  f"{k['name']}: two runs give other gradients")
            del again
        del qkv, r, ct, out
        torch.cuda.empty_cache()
    stats["bf16_by_output"] = {n: dict(err=e, floor=f)
                               for n, (e, f) in worst.items()}
    return stats


# the global backward's three parts by the names of their kernels (the
# wgmma cuts at 1024 px, the mma.sync ones on other grids)
BWD_PARTS = {"delta_ms": ("delta_kernel",),
             "dq_cut_ms": ("dq_wgmma_kernel", "bwd_dq_tc_kernel"),
             "dkv_cut_ms": ("dkv_wgmma_kernel", "bwd_dkv_tc_kernel")}


def bwd_parts(k: dict) -> dict:
    """A bf16 backward's parts by kernel name: K3's, or the windowed
    backward's as its rule (``window_bwd_kernels``) names them."""
    if k["name"] == "relpos_global_bwd":
        return BWD_PARTS
    return {part: (name,) for part, name in zip(
        BWD_PARTS, fa.window_bwd_kernels(torch.bfloat16, k["grid"]))}


def bwd_parts_ms(kernel, parts: dict, launches: int = 20) -> dict:
    """A backward's three parts on the device: a profiler pass over
    ``launches`` calls of the backward as training makes them, each part's
    device time per launch read by its kernel's name; the pass must see
    every launch."""
    events = time_kernels.kernel_events(kernel, launches)
    times = {}
    for part, names in parts.items():
        found = [e for e in events if any(name in e.key for name in names)]
        seen = sum(e.count for e in found)
        check(seen == launches,
              f"the profiler saw {[(e.key, e.count) for e in found]} for "
              f"{part}, not {launches} launches")
        times[part] = sum(e.self_device_time_total for e in found) / 1e3 \
            / seen
    return times


def fused_window_inputs(k: dict) -> list:
    """fp32 operands of K8 as the encoder hands them over: the residual x
    and the qkv projection (B, Hp, Wp, C / 3C), r a (B, heads, Hp, Wp,
    2 ws) view of the (B, Hp, Wp, heads, 2 ws) einsum output, the output
    projection (C_out, C_in) and its bias."""
    rng = np.random.default_rng(1)
    b, hp, ws, heads = k["b"], k["hp"], k["ws"], k["heads"]
    c = heads * k["dh"]
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).cuda()
    r = (0.5 * f(b, hp, hp, heads, 2 * ws)).permute(0, 3, 1, 2, 4)
    return [f(b, hp, hp, c), f(b, hp, hp, 3 * c), r, f(c, c) / c ** 0.5,
            0.1 * f(c)]


def fused_window_bound(k: dict, exp_rate: float) -> dict:
    """Least time the card could take for one K8 call in bf16. Operations:
    the windows' q.k^T and P.v products (4 T^2 dh flops a head and window)
    and the projection (2 Hp Wp C^2) on the tensor cores, one exponential a
    score on the special-function units; the longer of the two. Bytes: x,
    qkv, r, the projection's weight and bias read and out written once."""
    b, hp, ws, heads, dh = (k[x] for x in ("b", "hp", "ws", "heads", "dh"))
    c, t = heads * dh, ws * ws
    windows = b * (hp // ws) ** 2
    flops = windows * heads * 4 * t * t * dh + 2 * b * hp * hp * c * c
    exps = windows * heads * t * t
    nbytes = 2 * (b * hp * hp * (c + 3 * c + heads * 2 * ws + c) + c * c + c)
    t_ops = max(flops / PEAK_FLOPS, exps / exp_rate)
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, exps=exps, bytes=nbytes)


@torch.no_grad()
def check_fused_window(k: dict, exp_rate: float) -> dict:
    """K8 against ``fused_window_plain``: fp32 (rtol = atol = 1e-4) and
    bf16 (the 4x rule); the unfused kernel path on the same operands is
    held against the twin in fp32 and timed beside kernel and twin."""
    args = (k["dh"] ** -0.5, k["heads"], k["ws"])
    inputs = fused_window_inputs(k)
    before = fa.LAUNCHES["fused_window"]
    out = fw.fused_window_attention(*inputs, *args)
    ref = fw.fused_window_plain(*inputs, *args)
    torch.cuda.synchronize()
    check(fa.LAUNCHES["fused_window"] == before + 1,
          "fused_window: one launch a call")
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    err32 = (out - ref).abs().max().item()
    unfused32 = unfused_window_call(*inputs, k["heads"], k["ws"])
    torch.testing.assert_close(unfused32(), ref, rtol=1e-4, atol=1e-4)
    low = [t.bfloat16() for t in inputs]
    out = fw.fused_window_attention(*low, *args)
    ref = fw.fused_window_plain(*low, *args).float()
    ref32 = fw.fused_window_plain(*[t.float() for t in low], *args)
    err16 = (out.float() - ref).abs().max().item()
    floor = (ref - ref32).abs().max().item()
    check(err16 <= 4 * floor + 1e-6, f"fused_window dh {k['dh']} bf16 error "
          f"{err16} > 4 x floor {floor}")
    unfused = unfused_window_call(*low, k["heads"], k["ws"])
    unfused_err = (unfused().float() - ref32).abs().max().item()
    del out, ref, ref32
    return dict(
        max_abs_err=err32, max_abs_err_bf16=err16, bf16_floor=floor,
        unfused_err_bf16=unfused_err,
        ms=median_ms(lambda: fw.fused_window_attention(*low, *args)),
        plain_ms=median_ms(lambda: fw.fused_window_plain(*low, *args)),
        library_ms=median_ms(unfused),
        device_ms=device_ms(lambda: fw.fused_window_attention(*low, *args)),
        library_device_ms=device_ms(unfused),
        ms_fp32=median_ms(lambda: fw.fused_window_attention(*inputs, *args)),
        plain_ms_fp32=median_ms(lambda: fw.fused_window_plain(*inputs,
                                                              *args)),
        library_ms_fp32=median_ms(unfused32),
        **fused_window_bound(k, exp_rate))


def check_fused_window_all() -> dict:
    """K8 at ViT-B's and ViT-H's shapes; the summary's numbers are ViT-B's,
    ViT-H's nested under ``vit_h``."""
    exp_rate = card_exp_rate()
    out = {}
    for model, k in (("vit_b", FUSED_WINDOW), ("vit_h", FUSED_WINDOW_H)):
        s = out[model] = check_fused_window(k, exp_rate)
        print(f"kernel fused_window, {model}: 1 image, 25 windows, "
              f"{k['heads']} heads of {k['dh']}: fp32 err "
              f"{s['max_abs_err']:.3g}, bf16 err {s['max_abs_err_bf16']:.3g} "
              f"(floor {s['bf16_floor']:.3g}; the unfused path's bf16 "
              f"{s['unfused_err_bf16']:.3g}); bf16 {s['ms']:.4f} ms vs plain "
              f"{s['plain_ms']:.4f} ms, unfused kernel path "
              f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms by "
              f"{s['bound_by']}; fp32 {s['ms_fp32']:.4f} ms vs plain "
              f"{s['plain_ms_fp32']:.4f} ms, unfused "
              f"{s['library_ms_fp32']:.4f} ms; the unfused path is its "
              f"yardstick: {ratio_text(s)}")
    summary = dict(out["vit_b"])
    summary["vit_h"] = out["vit_h"]
    return {"fused_window": summary}


def int8_bound(k: dict, exp_rate: float) -> dict:
    """Least time the card could take for one int8-score call in bf16: the
    score products in int8 and P.v in bf16 share the tensor cores (2 N^2 dh
    operations a head each), the exponentials (one a score) run on the
    special-function units beside them; the longer of the two, against the
    bytes of qkv, r and out."""
    kh, kw = k["grid"]
    b, n, c = k["b"], kh * kw, HEADS * 64
    pairs = b * HEADS * n * n
    t_tc = 2 * pairs * 64 / PEAK_INT8_OPS + 2 * pairs * 64 / PEAK_FLOPS
    t_ops = max(t_tc, pairs / exp_rate)
    nbytes = 2 * b * n * (3 * c + HEADS * (kh + kw) + c)
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                tensor_core_ms=1e3 * t_tc, exp_ms=1e3 * pairs / exp_rate,
                bytes=nbytes)


@torch.no_grad()
def check_int8() -> dict:
    """The int8 kernel against the int8 twin: fp32 (rtol = atol = 1e-4),
    bf16 by the 4x rule (the twin on bf16 and on fp32-cast inputs); its
    drift from the bf16 kernel; kernel, twin, the bf16 kernel and SDPA on
    the expanded bias timed."""
    k = INT8
    args = kernel_args(k)
    qkv, r, _ = kernel_inputs(k)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention_relpos_lanes(qkv, r, *args, int8_scores=True)
    ref = fa.relpos_attention_int8_plain(qkv, r, *args)
    torch.cuda.synchronize()
    check(fa.LAUNCHES["relpos_global_int8"] == before["relpos_global_int8"] + 1
          and fa.LAUNCHES["relpos_global"] == before["relpos_global"],
          "relpos_global_int8: one launch a call")
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    err32 = (out - ref).abs().max().item()
    qb, rb = qkv.bfloat16(), r.bfloat16()
    out = fa.flash_attention_relpos_lanes(qb, rb, *args, int8_scores=True)
    ref = fa.relpos_attention_int8_plain(qb, rb, *args).float()
    ref32 = fa.relpos_attention_int8_plain(qb.float(), rb.float(), *args)
    err16 = (out.float() - ref).abs().max().item()
    floor = (ref - ref32).abs().max().item()
    check(err16 <= 4 * floor + 1e-6,
          f"relpos_global_int8 bf16 error {err16} > 4 x floor {floor}")
    full = fa.flash_attention_relpos_lanes(qb, rb, *args).float()
    drift = (out.float() - full).abs().max().item() / full.abs().max().item()
    del out, ref, ref32, full
    stats = dict(
        max_abs_err=err32, max_abs_err_bf16=err16, bf16_floor=floor,
        drift_from_bf16_kernel=drift,
        ms=median_ms(lambda: fa.flash_attention_relpos_lanes(
            qb, rb, *args, int8_scores=True)),
        plain_ms=median_ms(lambda: fa.relpos_attention_int8_plain(qb, rb,
                                                                  *args)),
        library_ms=median_ms(lambda: library_attention(qb, rb, k["grid"])),
        device_ms=device_ms(lambda: fa.flash_attention_relpos_lanes(
            qb, rb, *args, int8_scores=True)),
        library_device_ms=device_ms(
            lambda: library_attention(qb, rb, k["grid"])),
        bf16_kernel_ms=median_ms(lambda: fa.flash_attention_relpos_lanes(
            qb, rb, *args)),
        ms_fp32=median_ms(lambda: fa.flash_attention_relpos_lanes(
            qkv, r, *args, int8_scores=True)),
        plain_ms_fp32=median_ms(lambda: fa.relpos_attention_int8_plain(
            qkv, r, *args)), **int8_bound(k, card_exp_rate()))
    print(f"kernel relpos_global_int8 b 1 grid (64, 64): fp32 err "
          f"{err32:.3g}, bf16 err {err16:.3g} (floor {floor:.3g}); relative "
          f"drift from the bf16 kernel {drift:.3g}; bf16 {stats['ms']:.4f} ms "
          f"vs plain {stats['plain_ms']:.4f} ms, library "
          f"{stats['library_ms']:.4f} ms, bf16 kernel "
          f"{stats['bf16_kernel_ms']:.4f} ms, bound {stats['bound_ms']:.4f} "
          f"ms by {stats['bound_by']} (tensor cores "
          f"{stats['tensor_core_ms']:.4f} ms, exponentials "
          f"{stats['exp_ms']:.4f} ms); fp32 {stats['ms_fp32']:.4f} ms vs "
          f"plain {stats['plain_ms_fp32']:.4f} ms; {ratio_text(stats)}")
    return {k["name"]: stats}


def phase_kernels() -> dict:
    results = {}
    for k in KERNELS + PACKED_KERNELS:
        stats = check_backward(k) if k["backward"] else check_forward(k)
        extra = ""
        if k["backward"]:
            extra = (f"; its forward kernel at these shapes: fp32 err "
                     f"{stats['fwd_max_abs_err']:.3g}, bf16 err "
                     f"{stats['fwd_max_abs_err_bf16']:.3g}; two runs give "
                     f"the same bits")
            if "delta_ms" in stats:
                extra += (f"; its parts on the device: delta "
                          f"{stats['delta_ms']:.4f} ms, query cut "
                          f"{stats['dq_cut_ms']:.4f} ms, key cut "
                          f"{stats['dkv_cut_ms']:.4f} ms")
        elif "dh" in k:
            stats.update(check_packed_layouts(k))
            extra = (f"; strided view == contiguous tensor; gradient (kernel "
                     f"forward, plain backward) against autograd of the "
                     f"plain twin: err {stats['grad_max_abs_err']:.3g}")
        results[k["name"]] = dict(stats, **bound(k))
        s = results[k["name"]]
        print(f"kernel {k['name']} b {k['b']} grid {k['grid']}: fp32 err "
              f"{s['max_abs_err']:.3g}, bf16 err {s['max_abs_err_bf16']:.3g} "
              f"(floor {s['bf16_floor']:.3g}); bf16 {s['ms']:.4f} ms vs "
              f"plain {s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} "
              f"ms, bound {s['bound_ms']:.4f} ms by {s['bound_by']}; fp32 "
              f"{s['ms_fp32']:.4f} ms vs plain {s['plain_ms_fp32']:.4f} ms"
              + extra + f"; {ratio_text(s)}; {share_text(s)}")
        if "device_ms_fp32" in s:
            print(f"  fp32 on the device: {s['device_ms_fp32']:.4f} ms vs "
                  f"plain {s['plain_device_ms_fp32']:.4f} ms")
    audit_launches()
    k1 = results["relpos_global"]
    k1["kernel"], seen = check_global_route(KERNELS[0])
    k1["lse_max_rel_err"] = check_global(KERNELS[0])["lse_max_rel_err"]
    print(f"kernel relpos_global b 1 grid (64, 64): runs {k1['kernel']} "
          f"(found by name in a profiler pass over 20 calls, {seen} "
          f"launches seen); log-sum-exp error "
          f"{k1['lse_max_rel_err']:.3g} of 1 + |lse|")
    for label, k in GLOBAL_MORE.items():
        s = k1[label] = check_global(k)
        text = (f"kernel relpos_global {label}: b {k['b']}, "
                f"{k.get('heads', HEADS)} heads: bf16 err "
                f"{s['max_abs_err_bf16']:.3g} (floor "
                f"{s['bf16_floor']:.3g}), log-sum-exp error "
                f"{s['lse_max_rel_err']:.3g} of 1 + |lse|")
        if k["timed"]:
            text += (f"; {'with' if k.get('lse') else 'without'} the "
                     f"log-sum-exp bf16 {s['ms']:.4f} ms vs plain "
                     f"{s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} "
                     f"ms, bound {s['bound_ms']:.4f} ms by {s['bound_by']}; "
                     f"{ratio_text(s)}; {share_text(s)}")
        print(text)
    for label, k in WINDOW_MORE.items():
        s = results["relpos_window"][label] = dict(check_forward(k),
                                                   **bound(k))
        print(f"kernel relpos_window {label}: b {k['b']}, "
              f"{k.get('heads', HEADS)} heads: fp32 err "
              f"{s['max_abs_err']:.3g}, bf16 err {s['max_abs_err_bf16']:.3g} "
              f"(floor {s['bf16_floor']:.3g}); bf16 {s['ms']:.4f} ms vs plain "
              f"{s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} ms, "
              f"bound {s['bound_ms']:.4f} ms by {s['bound_by']}; fp32 on the "
              f"device {s['device_ms_fp32']:.4f} ms vs plain "
              f"{s['plain_device_ms_fp32']:.4f} ms; {ratio_text(s)}; "
              f"{share_text(s)}")
    for label, k in PACKED_MORE.items():
        s = results[k["name"]][label] = dict(check_forward(k), **bound(k))
        check_packed_layouts(k, gradient=False)
        print(f"kernel {k['name']} {label}: b {k['b']}, {k['heads']} heads "
              f"of {k['dh']}: fp32 err {s['max_abs_err']:.3g}, bf16 err "
              f"{s['max_abs_err_bf16']:.3g} (floor {s['bf16_floor']:.3g}); "
              f"bf16 {s['ms']:.4f} ms vs plain {s['plain_ms']:.4f} ms, "
              f"library {s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} "
              f"ms by {s['bound_by']}; fp32 on the device "
              f"{s['device_ms_fp32']:.4f} ms vs plain "
              f"{s['plain_device_ms_fp32']:.4f} ms; {ratio_text(s)}; "
              f"{share_text(s)}")
    for k in GENERAL_PATH + [PACKED_GENERAL_PATH]:
        s = (check_backward if k["backward"] else check_forward)(k, False)
        if "dh" in k:
            check_packed_layouts(k)
        elif not k["backward"]:
            check(check_global_route(k)[0] == "relpos_global_tc_kernel",
                  f"{k['name']} grid {k['grid']}: not the mma.sync "
                  f"kernel")
        print(f"kernel {k['name']}, general bias path, b {k['b']} grid "
              f"{k['grid']}: fp32 err {s['max_abs_err']:.3g}, bf16 err "
              f"{s['max_abs_err_bf16']:.3g} (floor {s['bf16_floor']:.3g})")
    variants = check_variants()
    for name, s in variants.items():
        print(f"kernel {name} (microbench variant) b 1: bf16 err "
              f"{s['max_abs_err']:.3g} (floor {s['bf16_floor']:.3g}); "
              f"{s['ms']:.4f} ms a launch vs plain {s['plain_ms']:.4f} ms, "
              f"library {s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} "
              f"ms by {s['bound_by']}; {ratio_text(s)}")
    results.update(variants)
    results.update(check_twoway())
    results.update(check_flash_all())
    results.update(check_fused_window_all())
    results.update(check_int8())
    return results


def card_exp_rate() -> float:
    """Exponentials a second the card can start: EXP_PER_CLOCK_SM on each
    SM at the maximum SM clock nvidia-smi reports."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXP_PER_CLOCK_SM * sms * mhz * 1e6


def flash_bound(k: dict, exp_rate: float) -> dict:
    """Least time the card could take for one flash call in bf16: the
    larger of its operations' time and bytes / memory rate. Operations:
    the q.k^T and P.v products (4 Q K dh flops a head) on the tensor cores
    and one exponential a score on the special-function units; whichever
    takes longer bounds them. Bytes: q, k, v read and out written once."""
    pairs = k["b"] * k["heads"] * k["nq"] * k["nk"]
    flops = 4 * pairs * k["dh"]
    nbytes = 2 * k["b"] * k["heads"] * (2 * k["nq"] + 2 * k["nk"]) * k["dh"]
    t_mma, t_exp = flops / PEAK_FLOPS, pairs / exp_rate
    t_ops, t_bytes = max(t_mma, t_exp), nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                mma_bound_ms=1e3 * t_mma, exp_bound_ms=1e3 * t_exp,
                bytes_bound_ms=1e3 * t_bytes, flops=flops, exps=pairs,
                bytes=nbytes)


def flash_inputs(k: dict) -> tuple:
    """fp32 q (B, H, Q, dh) and k, v (B, H, K, dh) as the affinity
    attention hands them over: head-split views of token-major
    projections, not copied."""
    rng = np.random.default_rng(1)
    b, heads, dh = k["b"], k["heads"], k["dh"]
    return tuple(
        torch.from_numpy(rng.standard_normal((b, n, heads * dh), np.float32))
        .cuda().view(b, n, heads, dh).transpose(1, 2)
        for n in (k["nq"], k["nk"], k["nk"]))


def library_flash(q, k, v, scale):
    """The same function through one library call."""
    return F.scaled_dot_product_attention(q, k, v, scale=scale)


@torch.no_grad()
def check_flash(k: dict, timed: bool = True) -> dict:
    """K6 against its twin: fp32 (rtol = atol = 1e-4), bf16 by the 4x rule;
    the strided views against contiguous tensors, bit for bit in bf16 (the
    output then lies as q does); timed: kernel, twin and the library call
    in bf16, kernel and twin in fp32."""
    q, kk, v = flash_inputs(k)
    scale = k["dh"] ** -0.5
    # the launch counter of the route this head width takes
    key = fa.flash_route(k["dh"], torch.bfloat16)[0]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, kk, v, scale)
    ref = fa.flash_attention_plain(q, kk, v, scale)
    torch.cuda.synchronize()
    check(fa.LAUNCHES[key] == before[key] + 1
          and sum(fa.LAUNCHES.values()) == sum(before.values()) + 1,
          f"flash dh {k['dh']}: one launch a call, counted under {key}")
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    err32 = (out - ref).abs().max().item()
    del out, ref
    qb, kb, vb = (x.bfloat16() for x in (q, kk, v))
    out = fa.flash_attention(qb, kb, vb, scale)
    ref32 = fa.flash_attention_plain(qb.float(), kb.float(), vb.float(), scale)
    ref = fa.flash_attention_plain(qb, kb, vb, scale).float()
    err16 = (out.float() - ref).abs().max().item()
    floor = (ref - ref32).abs().max().item()
    del ref
    check(err16 <= 4 * floor + 1e-6,
          f"flash {k['nq']} x {k['nk']} dh {k['dh']} bf16 error {err16} > 4 x "
          f"floor {floor}")
    dense = fa.flash_attention(qb.contiguous(), kb.contiguous(),
                               vb.contiguous(), scale)
    check(fa._token_major(qb) and fa._token_major(out)
          and dense.is_contiguous(), "flash: unexpected layouts")
    check(torch.equal(out, dense), "flash: the strided views and the "
          "contiguous tensors give other bits")
    stats = dict(max_abs_err=err32, max_abs_err_bf16=err16, bf16_floor=floor,
                 launch_key=key)
    if timed:
        lib_err = (library_flash(qb, kb, vb, scale).float() - ref32
                   ).abs().max().item()
        check(lib_err <= 4 * floor + 1e-6,
              "flash: the library call computes another function")
        del ref32, out, dense
        stats.update(
            ms=median_ms(lambda: fa.flash_attention(qb, kb, vb, scale)),
            plain_ms=median_ms(lambda: fa.flash_attention_plain(qb, kb, vb,
                                                                scale)),
            library_ms=median_ms(lambda: library_flash(qb, kb, vb, scale)),
            device_ms=device_ms(lambda: fa.flash_attention(qb, kb, vb, scale),
                                50),
            library_device_ms=device_ms(
                lambda: library_flash(qb, kb, vb, scale), 50),
            ms_fp32=median_ms(lambda: fa.flash_attention(q, kk, v, scale),
                              iters=5),
            plain_ms_fp32=median_ms(
                lambda: fa.flash_attention_plain(q, kk, v, scale), iters=5))
    return stats


def check_flash_all() -> dict:
    """K6 at the path's shape (timed, with its bound), at the other shapes,
    and a gradient through its autograd function (kernel forward, the twin
    recomputed for the backward) against autograd through the twin."""
    exp_rate = card_exp_rate()
    for k in [FLASH] + FLASH_OTHER:
        stats = check_flash(k, timed=k is FLASH)
        print(f"kernel flash b {k['b']} heads {k['heads']} {k['nq']} x "
              f"{k['nk']} dh {k['dh']} ({stats['launch_key']}): fp32 err "
              f"{stats['max_abs_err']:.3g}, bf16 err "
              f"{stats['max_abs_err_bf16']:.3g} (floor "
              f"{stats['bf16_floor']:.3g}); strided views == contiguous")
        if k is FLASH:
            s = dict(stats, **flash_bound(k, exp_rate))
    print(f"kernel flash at the affinity call: bf16 {s['ms']:.4f} ms vs plain "
          f"{s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} ms, bound "
          f"{s['bound_ms']:.4f} ms by {s['bound_by']} (tensor cores "
          f"{s['mma_bound_ms']:.4f} ms, exponentials {s['exp_bound_ms']:.4f} "
          f"ms at {exp_rate:.4g} a second, bytes {s['bytes_bound_ms']:.4f} "
          f"ms); fp32 {s['ms_fp32']:.4f} ms vs plain "
          f"{s['plain_ms_fp32']:.4f} ms; {ratio_text(s)}")
    k = FLASH_OTHER[0]
    q, kk, v = flash_inputs(k)
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal(
        q.shape, np.float32)).cuda()
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        leaves = [x.detach().requires_grad_() for x in (q, kk, v)]
        before = fa.LAUNCHES["flash"]
        grads.append(torch.autograd.grad(fn(*leaves, k["dh"] ** -0.5),
                                         leaves, ct))
        check(fa.LAUNCHES["flash"] - before == int(fn is fa.flash_attention),
              "flash: launches of the gradient check")
    torch.cuda.synchronize()
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    s["grad_max_abs_err"] = max((g - x).abs().max().item()
                                for g, x in zip(*grads))
    print(f"kernel flash: gradient (kernel forward, plain backward) against "
          f"autograd of the plain twin: err {s['grad_max_abs_err']:.3g}")
    # the backward's recompute over blocks of query rows, as it runs at the
    # affinity decoder's call, against the recompute at once (fp32)
    q, kk, v = flash_inputs(FLASH)
    ct = torch.from_numpy(np.random.default_rng(4).standard_normal(
        q.shape, np.float32)).cuda()
    scale = FLASH["dh"] ** -0.5
    rows = fa.recompute_rows(q, kk, fa.RECOMPUTE_BYTES)
    check(rows < q.shape[2], "flash: the affinity call's recompute is not "
          "blocked")
    blocked = fa.flash_attention_bwd_plain(q, kk, v, ct, scale, rows)
    whole = fa.flash_attention_bwd_plain(q, kk, v, ct, scale)
    torch.cuda.synchronize()
    for got, ref in zip(blocked, whole):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    s["blocked_grad_max_abs_err"] = max((g - x).abs().max().item()
                                        for g, x in zip(blocked, whole))
    print(f"kernel flash: backward recompute in blocks of {rows} query rows "
          f"against the recompute at once at {tuple(q.shape)} x "
          f"{tuple(kk.shape)}: err {s['blocked_grad_max_abs_err']:.3g}")
    del blocked, whole
    torch.cuda.empty_cache()
    return {"flash": s}


def twoway_bound(g: int) -> dict:
    """Least time the card could take for the two-way transformer on ``g``
    instances in bf16. Operations: per block the three image-side
    projections and the out projection (8 S D I), both cross-attentions'
    scores and value products (8 N S I), the tokens' self-attention (8 N D^2
    + 4 N^2 D), cross projections (8 N D I) and MLP (4 N D mlp); at the end
    two image-side projections (4 S D I), scores and values (4 N S I) and
    the tokens' projections (4 N D I). Bytes: keys and queries in and out
    (bf16), the positional grid, and the parameters as the function is
    handed them (fp32), each once."""
    k = TWOWAY
    s, n, d, i, mlp = k["s"], k["n"], k["d"], k["inner"], k["mlp"]
    block = (8 * s * d * i + 8 * n * s * i + 8 * n * d * d + 4 * n * n * d
             + 8 * n * d * i + 4 * n * d * mlp)
    final = 4 * s * d * i + 4 * n * s * i + 4 * n * d * i
    flops = g * (k["depth"] * block + final)
    attn = lambda inner: 2 * d * inner + 2 * d * inner + inner + inner \
        + inner + d
    n_params = (k["depth"] * (attn(d) + 2 * attn(i) + 2 * d * mlp + mlp + d
                              + 8 * d) + attn(i) + 2 * d)
    nbytes = 2 * (2 * g * (s + n) * d + s * d) + 4 * n_params
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def twoway_gradient_error(got: list, ref: list) -> float:
    """Worst error of a gradient tensor over its own largest entry. Tensors
    whose largest entry is under 1e-6 of the largest over all tensors (the
    key projections' biases, whose gradient is zero in exact arithmetic) hold
    rounding only: they must stay under that floor and count as exact."""
    floor = 1e-6 * max(y.abs().max().item() for y in ref)
    worst = 0.0
    for x, y in zip(got, ref):
        scale = y.abs().max().item()
        if scale < floor:
            check(x.abs().max().item() < floor, "fused_twoway: a gradient "
                  "that is zero in exact arithmetic is not")
        else:
            worst = max(worst, (x - y).abs().max().item() / scale)
    return worst


def check_twoway() -> dict:
    """The fused TwoWayTransformer kernel against ``twoway_plain`` at both
    call sites of the decode path; the summary's numbers are those of the
    prompt encoder's site."""
    k = TWOWAY
    tr = TwoWayTransformer(k["depth"], k["d"], k["heads"], k["mlp"],
                           dtype=torch.bfloat16).cuda()
    init_weights(tr, SEED)
    params = ft.twoway_params(tr)
    check(len(params) == ft.twoway_param_count(k["depth"]) and sum(
        p.numel() for p in params) == (twoway_bound(1)["bytes"]
                                       - 2 * (2 * (k["s"] + k["n"]) * k["d"]
                                              + k["s"] * k["d"])) // 4,
          "fused_twoway: the bound's parameter count")
    args = (params, k["depth"], k["heads"])
    grid = int(k["s"] ** 0.5)
    out = {}
    for site, g in TWOWAY_SITES.items():
        rng = np.random.default_rng(1)
        keys, queries, pe = (
            torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()
            for shape in ((g, k["s"], k["d"]), (g, k["n"], k["d"]),
                          (k["s"], k["d"])))
        stats = {}
        with torch.no_grad():
            before = fa.LAUNCHES["fused_twoway"]
            got = ft.fused_twoway_transformer(keys, queries, pe, *args)
            ref = ft.twoway_plain(keys, queries, pe, *args)
            torch.cuda.synchronize()
            check(fa.LAUNCHES["fused_twoway"] == before + 1,
                  "fused_twoway: one launch a call")
            for x, y in zip(got, ref):
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
            stats["max_abs_err"] = max((x - y).abs().max().item()
                                       for x, y in zip(got, ref))
            kb, qb, pb = keys.bfloat16(), queries.bfloat16(), pe.bfloat16()
            got = ft.fused_twoway_transformer(kb, qb, pb, *args)
            ref = ft.twoway_plain(kb, qb, pb, *args)
            ref32 = ft.twoway_plain(kb.float(), qb.float(), pb.float(), *args)
            torch.cuda.synchronize()
            worst = {}
            for name, x, y, y32 in zip(("queries", "keys"), got, ref, ref32):
                err = (x.float() - y.float()).abs().max().item()
                floor = (y.float() - y32).abs().max().item()
                check(x.dtype == torch.bfloat16 and err <= 4 * floor + 1e-6,
                      f"fused_twoway {site} bf16 {name} error {err} > 4 x "
                      f"floor {floor}")
                worst[name] = dict(err=err, floor=floor)
            stats["max_abs_err_bf16"] = max(w["err"] for w in worst.values())
            stats["bf16_floor"] = max(w["floor"] for w in worst.values())
            stats["bf16_by_output"] = worst
            del got, ref, ref32
            module_args = (kb.view(g, grid, grid, -1),
                           pb.view(1, grid, grid, -1), qb)

            def module_path():
                with fa.plain_attention():
                    return tr(*module_args)

            stats.update(
                ms=median_ms(lambda: ft.fused_twoway_transformer(kb, qb, pb,
                                                                 *args)),
                device_ms=device_ms(lambda: ft.fused_twoway_transformer(
                    kb, qb, pb, *args)),
                plain_ms=median_ms(lambda: ft.twoway_plain(kb, qb, pb, *args)),
                module_ms=median_ms(module_path), library_ms=None,
                ms_fp32=median_ms(lambda: ft.fused_twoway_transformer(
                    keys, queries, pe, *args), iters=5),
                plain_ms_fp32=median_ms(lambda: ft.twoway_plain(
                    keys, queries, pe, *args), iters=5))
        capacity = ft.cluster_capacity(keys.device)
        cluster = ft.twoway_cluster(g, k["s"], capacity)
        out[site] = dict(stats, instances=g, cluster=cluster,
                         **twoway_bound(g))
        s = out[site]
        print(f"kernel fused_twoway, {site}: {g} instances x {k['s']} image "
              f"tokens x {k['n']} tokens, bf16 in clusters of {cluster} "
              f"blocks (clusters the card holds at once, by blocks: "
              f"{capacity}): fp32 err {s['max_abs_err']:.3g}, "
              f"bf16 err {s['max_abs_err_bf16']:.3g} (floor "
              f"{s['bf16_floor']:.3g}); bf16 {s['ms']:.4f} ms vs plain "
              f"{s['plain_ms']:.4f} ms, module path {s['module_ms']:.4f} ms, "
              f"bound {s['bound_ms']:.4f} ms by {s['bound_by']}; fp32 "
              f"{s['ms_fp32']:.4f} ms vs plain {s['plain_ms_fp32']:.4f} ms; "
              f"on the device {s['device_ms']:.4f} ms; {share_text(s)}")
    # gradient: kernel forward, recomputed plain backward, against autograd
    # through the twin (fp32, mask decoder's site)
    grads = []
    for fn in (ft.fused_twoway_transformer, ft.twoway_plain):
        tr.zero_grad()
        a, b = keys.detach().requires_grad_(), queries.detach().requires_grad_()
        before = fa.LAUNCHES["fused_twoway"]
        q_out, k_out = fn(a, b, pe, *args)
        (q_out.square().sum() + k_out.square().sum()).backward()
        check(fa.LAUNCHES["fused_twoway"] - before
              == int(fn is ft.fused_twoway_transformer),
              "fused_twoway: launches of the gradient check")
        grads.append([a.grad, b.grad] + [p.grad.clone() for p in params])
    torch.cuda.synchronize()
    worst = twoway_gradient_error(*grads)
    check(worst <= 1e-3, f"fused_twoway: gradient through the function, "
          f"relative error {worst}")
    print(f"kernel fused_twoway: gradient (kernel forward, plain backward) "
          f"against autograd of the plain twin, {len(grads[0])} tensors, "
          f"worst error {worst:.3g} of the tensor's largest gradient")
    tr.zero_grad()
    summary = dict(out["prompt_encoder"])
    for site in list(TWOWAY_SITES)[1:]:
        summary[site + "_site"] = {
            key: out[site][key]
            for key in ("instances", "cluster", "max_abs_err",
                        "max_abs_err_bf16", "bf16_floor", "ms", "plain_ms",
                        "module_ms", "ms_fp32", "device_ms", "bound_ms",
                        "bound_by")}
    return {"fused_twoway": summary}


def compare_logits(gpu: np.ndarray, cpu: np.ndarray, what: str) -> None:
    """Card against CPU: the same finite mask, rtol 1e-3 / atol 5e-4 on
    the finite logits, argmax agreement > 0.999."""
    finite = np.isfinite(cpu)
    check(np.array_equal(np.isfinite(gpu), finite), "finite masks differ")
    check(finite.any(), "no finite logits")
    err = np.abs(gpu[finite] - cpu[finite])
    safe = lambda x: np.where(finite, x, -1e30)
    agree = (safe(gpu).argmax(1) == safe(cpu).argmax(1)).mean()
    print(f"{what}: max |gpu - cpu| {err.max():.3g} (logit scale "
          f"{np.abs(cpu[finite]).max():.3g}), argmax agreement {agree:.6f}")
    np.testing.assert_allclose(gpu[finite], cpu[finite], rtol=1e-3, atol=5e-4)
    check(agree > 0.999, f"{what}: argmax agreement {agree}")


def phase_parity() -> None:
    batch = random_batch(batch_size=1, num_examples=1, num_classes=2,
                         with_images=True, image_size=1024, seed=0)
    logits = {}
    for device in ("cuda", "cpu"):
        la = LabelAnything(dict(CONFIG, dtype="float32"), device, SEED)
        t0 = time.perf_counter()
        out = la.predict(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        logits[device] = out.float().cpu().numpy()
        print(f"parity: fp32 forward on {device} "
              f"{time.perf_counter() - t0:.2f} s")
        del la
    compare_logits(logits["cuda"], logits["cpu"], "parity")


def nonzero(launches: dict) -> dict:
    return {name: count for name, count in launches.items() if count}


def expect_launches(launches: dict, expected: dict, what: str) -> None:
    """Every counter holds what ``expected`` says, and 0 where it is silent."""
    for name, count in launches.items():
        check(count == expected.get(name, 0),
              f"{what}: {name} launched {count} times, expected "
              f"{expected.get(name, 0)}")


def phase_serve(config: dict = CONFIG, per_call: dict = ENCODER_LAUNCHES,
                shots: int = 5, requests: int = 3,
                profile: bool = False) -> tuple:
    """(launches, the first request's logits)."""
    name = config["name"]
    options = [k for k in ("fused_window", "int8_scores") if config.get(k)]
    la = LabelAnything(dict(config, dtype="bf16"), seed=SEED)   # on the card
    check(next(la.model.parameters()).is_cuda, f"{name} is not on the card")
    episode = random_batch(batch_size=1, num_examples=shots, num_classes=2,
                           with_images=True, image_size=1024, seed=1)
    support = {k: v[:, 1:] if k in (BatchKeys.IMAGES, BatchKeys.DIMS) else v
               for k, v in episode.items()}
    query = {BatchKeys.IMAGES: episode[BatchKeys.IMAGES][:, :1],
             BatchKeys.DIMS: episode[BatchKeys.DIMS][:, :1]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    t0 = time.perf_counter()
    embs = la.generate_class_embeddings(support)
    torch.cuda.synchronize()
    support_s = time.perf_counter() - t0
    latencies, outs = [], []
    for _ in range(requests):
        t0 = time.perf_counter()
        outs.append(la.predict(query, embs))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)

    calls = 1 + len(outs)   # encoder calls: the support set, each request
    expect_launches(launches, {k: v * calls for k, v in per_call.items()},
                    f"serve {name}")
    check(embs[ResultDict.CLASS_EMBS].shape == (1, 2, 512), "class embs shape")
    s = config["image_size"]
    h, w = (int(x) for x in episode[BatchKeys.DIMS][0, 0])
    valid_w = int(np.floor(w * (s / max(h, w)) + 0.5))
    for out in outs:
        check(tuple(out.shape) == (1, 2, s, s), f"logits shape {out.shape}")
        check(bool(torch.isfinite(out[..., :valid_w]).all()),
              "non-finite logits in the valid region")
        check(bool((out[:, 0, :, valid_w:] == 0).all()), "bg pad fill")
        check(bool(torch.isneginf(out[:, 1:, :, valid_w:]).all()),
              "fg pad fill")
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          "repeated requests differ")
    peak = torch.cuda.max_memory_allocated()
    print(f"serve {name}{''.join(' ' + o for o in options)}: support set "
          f"({shots} images) "
          f"{support_s * 1e3:.1f} ms; request "
          f"latency median {statistics.median(latencies) * 1e3:.1f} ms "
          f"(all {[round(x * 1e3, 1) for x in latencies]}); peak memory "
          f"{peak / 2**30:.2f} GiB; launches {nonzero(launches)}")
    if profile:
        profile_steps(lambda: la.predict(query, embs), 2, unit="request")
    return launches, outs[0]


def train_state(dtype: str, config: dict = CONFIG, **optimizer_args):
    """The full-width model with the seeded weights, the focal loss and
    AdamW, on the card (``init_train_state``'s default device)."""
    loss = LabelAnythingLoss({"focal": {"weight": 1.0}}, class_weighting=True)
    return init_train_state(dict(config, dtype=dtype), loss, seed=SEED,
                            name="AdamW", learning_rate=LEARNING_RATE,
                            **optimizer_args)


def training_batch(batch_size: int, shots: int):
    full = random_full_batch(batch_size=batch_size, num_examples=shots,
                             num_classes=2, image_size=1024, with_images=True,
                             include_masks=True, seed=2)
    sub = Substitutor(num_points=1, substitute=False)
    sub.reset({k: torch.as_tensor(v) for k, v in full.items()})
    batch, gt = next(sub)
    return {k: v.cuda() for k, v in batch.items()}, gt.cuda()


def relu_signs(model, signs: dict) -> list:
    """Forward hooks that append to ``signs[name]`` where the input of each
    ReLU unit of ``model`` is positive (the transformers' MLP blocks and
    the decoder's MLP heads); returns the hooks' handles."""
    targets = []
    for name, m in model.named_modules():
        if isinstance(m, MLPBlock) and m.act is F.relu:
            targets.append((name + ".lin1", m.lin1))
        elif isinstance(m, MLP):
            targets += [(f"{name}.layers.{i}", layer)
                        for i, layer in enumerate(m.layers[:-1])]
    return [layer.register_forward_hook(
        lambda mod, args, out, name=name: signs.setdefault(name, []).append(
            out.detach() > 0)) for name, layer in targets]


def flipped_units(signs: dict, ref: dict) -> int:
    """ReLU units on in one pass and off in the other."""
    return sum(int((a != b).sum()) for name in ref
               for a, b in zip(signs[name], ref[name]))


def gradient_pass(dtype: str, batch, gt, plain: bool = False,
                  config: dict = CONFIG, rows: tuple = (0, 7),
                  signs: dict = None):
    """One training pass (forward, loss, backward, no update) of a fresh
    train state with pinned class rows: (state, loss, gradients by name).
    With ``signs`` the ReLU units' signs go there (:func:`relu_signs`)."""
    state = train_state(dtype, config)
    check(next(state.model.parameters()).is_cuda,
          "the train state is not on the card")
    state.model.prompt_encoder.class_encoder.rows = rows
    hooks = [] if signs is None else relu_signs(state.model, signs)
    step = make_train_step()
    if plain:
        with fa.plain_attention():
            _, aux = step(state, batch, gt, None, 1.0, apply_update=False)
    else:
        _, aux = step(state, batch, gt, None, 1.0, apply_update=False)
    torch.cuda.synchronize()
    for hook in hooks:
        hook.remove()
    return state, float(aux["loss"]), {
        n: p.grad for n, p in state.model.named_parameters()}


def direction(grads: dict, ref: dict) -> tuple:
    """(cosine, norm of ``grads``, norm of ``ref``) over all parameters."""
    dot = sq = sq_ref = 0.0
    for name, g in ref.items():
        if g is not None:
            dot += float((grads[name] * g).sum())
            sq += float(grads[name].norm()) ** 2
            sq_ref += float(g.norm()) ** 2
    return dot / (sq * sq_ref) ** 0.5, sq ** 0.5, sq_ref ** 0.5


def gradient_verdict(loss: float, grads: dict, loss_ref: float,
                     grads_ref: dict, floors: dict = None,
                     flips: tuple = None) -> dict:
    """Phase 5's rules: loss within 1e-5 relative; each parameter's
    gradient within a relative L2 distance of GRAD_REL_L2, those under
    GRAD_FLOOR of the whole gradient's norm held to that floor, the rel-pos
    tables to their own norm. ``floors``: a second reference's gradients
    (the plain pass with fp64 scores); a parameter, and the gradient as a
    whole, may then also lie within 4 times the two references' distance,
    the bf16 rule's form (ReLU units whose input is within rounding of zero
    switch between fp32 passes, and move the gradients behind them by more
    than GRAD_REL_L2). ``flips``: the ReLU units that switch against the
    reference in this pass and in the second reference's; this pass may
    switch at most 4 times as many (at least 4). Returns the rows (relative
    L2, name, norm, allowed) worst first, the rel-pos tables' distances,
    the whole gradient's distance and allowance, ``ok`` and why not."""
    total = sum(float(g.norm()) ** 2 for g in grads_ref.values()
                if g is not None) ** 0.5
    rows, rel_pos, sq, sq_floor = [], {}, 0.0, 0.0
    for key, ref in grads_ref.items():
        got = grads[key]
        if got is None or ref is None:
            # no gradient and a gradient of zeros are the same: K7 skips
            # the prompt encoder's final attention, whose output the
            # module path computes and drops
            other = ref if got is None else got
            check(other is None or not bool(other.any()),
                  f"{key}: gradient present in one run only")
            continue
        check(bool(torch.isfinite(got).all()), f"{key}: gradient not finite")
        norm = ref.norm().item()
        # a gradient below GRAD_FLOOR of the whole gradient's norm is
        # rounding noise of its own sums; it is held to that floor instead
        diff = (got - ref).norm().item()
        sq += diff ** 2
        if key.endswith(("rel_pos_h", "rel_pos_w")):
            # fed by the attention's dr alone: held to its own norm
            check(norm > 0, f"{key}: zero gradient")
            rel_pos[key] = diff / norm
            scale = norm
        else:
            scale = max(norm, GRAD_FLOOR * total)
        allowed = GRAD_REL_L2
        if floors is not None and floors.get(key) is not None:
            floor = (floors[key] - ref).norm().item()
            sq_floor += floor ** 2
            allowed = max(allowed, 4 * floor / scale)
        rows.append((diff / scale, key, norm, allowed))
    rows.sort(key=lambda r: r[0] / r[3], reverse=True)
    whole = sq ** 0.5 / total
    whole_allowed = (None if floors is None
                     else max(GRAD_REL_L2, 4 * sq_floor ** 0.5 / total))
    why = []
    if not (np.isfinite(loss) and abs(loss - loss_ref) <= 1e-5 * abs(loss_ref)):
        why.append(f"loss {loss} vs {loss_ref}")
    if rows[0][0] > rows[0][3]:
        why.append(f"{rows[0][1]} relative L2 {rows[0][0]:.3g} (allowed "
                   f"{rows[0][3]:.3g})")
    if floors is not None and whole > whole_allowed:
        why.append(f"the whole gradient's relative L2 {whole:.3g} (allowed "
                   f"{whole_allowed:.3g})")
    if flips is not None and flips[0] > 4 * max(flips[1], 1):
        why.append(f"{flips[0]} ReLU units switched (rounding switches "
                   f"{flips[1]})")
    return dict(rows=rows, rel_pos=rel_pos, total=total, whole=whole,
                whole_allowed=whole_allowed, ok=not why, why="; ".join(why))


def compare_gradients(loss: float, grads: dict, loss_ref: float,
                      grads_ref: dict, what: str, name: str,
                      ref_name: str, rel_pos_tables: int = 24,
                      floors: dict = None, flips: tuple = None) -> dict:
    """:func:`gradient_verdict`'s rules, printed and checked; the
    ``rel_pos_tables`` rel-pos tables (24 in ViT-B) must all be there."""
    v = gradient_verdict(loss, grads, loss_ref, grads_ref, floors, flips)
    for rel, key, norm, allowed in v["rows"][:5]:
        print(f"{what}: relative L2 {rel:.3g} (allowed {allowed:.3g}, norm "
              f"{norm:.3g}) {key}")
    print(f"{what}: loss {name} {loss:.8f} {ref_name} {loss_ref:.8f}; "
          f"gradients of {len(v['rows'])} parameters, norm {v['total']:.4g}"
          f", relative L2 of the whole {v['whole']:.3g}"
          + (f" (allowed {v['whole_allowed']:.3g})" if floors is not None
             else "")
          + (f"; rel_pos_h / rel_pos_w worst {max(v['rel_pos'].values()):.3g}"
             if v["rel_pos"] else ""))
    check(len(v["rel_pos"]) == rel_pos_tables,
          f"{len(v['rel_pos'])} rel-pos tables")
    check(v["ok"], f"{what}: {v['why']}")
    return v


def phase_step_parity() -> None:
    batch, gt = training_batch(batch_size=1, shots=1)
    runs = {}
    for mode in ("kernels", "plain"):
        fa.reset_launches()
        t0 = time.perf_counter()
        runs[mode] = gradient_pass("float32", batch, gt, mode == "plain")
        launches = dict(fa.LAUNCHES)
        # 2 images in one encoder call, forward and backward
        expect_launches(launches, TRAIN_LAUNCHES if mode == "kernels" else {},
                        f"step parity ({mode})")
        print(f"step parity: fp32 pass through the {mode} "
              f"{time.perf_counter() - t0:.2f} s, loss {runs[mode][1]:.6f}, "
              f"launches {nonzero(launches)}")
    (state, loss_k, grads_k), (_, loss_p, grads_p) = (runs.pop("kernels"),
                                                      runs.pop("plain"))
    compare_gradients(loss_k, grads_k, loss_p, grads_p,
                      "step parity", "kernels", "plain")
    del grads_p

    # the same pass in bf16, as phase 6 trains: its whole gradient must
    # point where the fp32 one does
    _, loss_b, grads_b = gradient_pass("bf16", batch, gt)
    cosine, norm_b, norm_k = direction(grads_b, grads_k)
    print(f"step parity: bf16 pass loss {loss_b:.6f} (fp32 {loss_k:.6f}), "
          f"gradient norm {norm_b:.4g} (fp32 {norm_k:.4g}), cosine with "
          f"the fp32 gradient {cosine:.4f}")
    check(abs(loss_b - loss_k) <= BF16_LOSS_RTOL * abs(loss_k),
          f"bf16 loss {loss_b} vs fp32 {loss_k}")
    check(cosine >= BF16_GRAD_COSINE, f"bf16 gradient cosine {cosine}")
    del grads_b, grads_k

    # training proper, where rounding cannot hide it: five fp32 AdamW steps
    # through the kernels on this episode; the loss falls on the first
    # update and stands lower after the fifth step than before the first
    step, losses = make_train_step(), []
    for _ in range(FP32_STEPS):
        state, aux = step(state, batch, gt, None, 1.0, apply_update=True,
                          use_accum=False)
        losses.append(float(aux["loss"]))
    print(f"step parity: {FP32_STEPS} fp32 steps at lr {LEARNING_RATE}, "
          f"losses {[round(x, 8) for x in losses]}")
    check(abs(losses[0] - loss_k) <= 1e-6 * abs(loss_k),
          f"the first step's loss {losses[0]} is not the pass's {loss_k}")
    check(losses[1] < losses[0] and losses[-1] < losses[0],
          f"the fp32 loss did not fall: {losses}")


def profile_steps(run_step, steps: int = 2, unit: str = "step") -> None:
    """Kernel time by name and the device's busy share over a few training
    steps or requests (``torch.profiler``; its own host cost stretches the
    window, so the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               # kernels, not the optimizer's annotation ranges
               and not e.key.startswith("Optimizer.")]
    busy_ms = sum(t for t, _, _ in kernels)
    print(f"profile: {steps} {unit}s, {wall_ms / steps:.1f} ms a {unit} under "
          f"the profiler, kernel time {busy_ms / steps:.1f} ms a {unit} in "
          f"{sum(n for _, n, _ in kernels) // steps} kernels, device busy "
          f"{busy_ms / wall_ms:.3f} of the window")
    for t, n, key in sorted(kernels, reverse=True)[:12]:
        print(f"profile:   {t / steps:8.3f} ms a {unit}, {n // steps:5d} "
              f"launches  {key[:90]}")
    for t, n, key in sorted(kernels, reverse=True):
        if any(name in key for name in ("relpos", "twoway", "flash",
                                         "fused_window")):
            print(f"profile:   {t / n:8.4f} ms a launch on the device  "
                  f"{key[:90]}")


def encoder_digest(model) -> float:
    return sum(p.double().abs().sum().item()
               for p in model.image_encoder.parameters())


def report_batch_gradient(batch, gt) -> None:
    """With the seeded weights the training batch's two class logits differ
    by about 0.005 and its fp32 gradient is some 400 times smaller than the
    phase-5 episode's, below the rounding noise of a bf16 gradient: the
    losses of phase 6's steps move by noise, and the falling loss is
    checked in phase 5. Reported, not checked."""
    _, loss32, grads32 = gradient_pass("float32", batch, gt)
    _, loss16, grads16 = gradient_pass("bf16", batch, gt)
    cosine, norm16, norm32 = direction(grads16, grads32)
    print(f"train: this batch's gradient norm fp32 {norm32:.4g} (loss "
          f"{loss32:.6f}), bf16 {norm16:.4g} (loss {loss16:.6f}), cosine "
          f"{cosine:.4f}")


def phase_train() -> dict:
    batch, gt = training_batch(batch_size=2, shots=2)
    images = batch[BatchKeys.IMAGES].shape[0] * batch[BatchKeys.IMAGES].shape[1]
    report_batch_gradient(batch, gt)
    state = train_state("bf16")
    model = state.model
    step = make_train_step()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    generator = torch.Generator()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    losses, times, per_step = [], [], []
    for _ in range(1 + TRAIN_STEPS):
        # the same class rows on every step, as the JAX bench's fixed key
        generator.manual_seed(SEED)
        fa.reset_launches()
        t0 = time.perf_counter()
        state, aux = step(state, batch, gt, generator, 1.0,
                          apply_update=True, use_accum=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss"]))
        per_step.append(dict(fa.LAUNCHES))
    peak = torch.cuda.max_memory_allocated()

    check(all(np.isfinite(x) for x in losses), f"losses {losses}")
    for launches in per_step:
        expect_launches(launches, TRAIN_LAUNCHES, "a training step")
    check(state.step == 1 + TRAIN_STEPS, f"{state.step} updates")
    unchanged = []
    for name, p in model.named_parameters():
        check(bool(torch.isfinite(p).all()), f"{name} is not finite")
        if torch.equal(p, before[name]):
            unchanged.append(name)
    check(all(n.startswith(NO_GRADIENT) or n.endswith(ZERO_GRADIENT)
              for n in unchanged),
          f"parameters that did not move: {unchanged}")
    timed = times[1:]
    ms = statistics.median(timed) * 1e3
    print(f"train: {images} images a step, bf16, losses "
          f"{[round(x, 6) for x in losses]}; warm-up {times[0] * 1e3:.1f} ms, "
          f"steps {[round(x * 1e3, 1) for x in timed]} ms, median {ms:.1f} ms"
          f" = {images / ms * 1e3:.2f} images/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step "
          f"{nonzero(per_step[-1])}; "
          f"{len(unchanged)} of {len(before)} parameters did not move")
    total = {name: sum(x[name] for x in per_step) for name in TRAIN_LAUNCHES}
    del before

    def one_more_step():
        generator.manual_seed(SEED)
        step(state, batch, gt, generator, 1.0, apply_update=True,
             use_accum=False)

    profile_steps(one_more_step)

    # the configuration's own variant: the backbone frozen
    state = init_train_state(model, state.loss, name="AdamW",
                             learning_rate=LEARNING_RATE, freeze_backbone=True)
    digest = encoder_digest(model)
    generator.manual_seed(SEED)
    fa.reset_launches()
    t0 = time.perf_counter()
    state, aux = step(state, batch, gt, generator, 1.0, apply_update=True,
                      use_accum=False)
    torch.cuda.synchronize()
    frozen_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.LAUNCHES)
    check(np.isfinite(float(aux["loss"])), "frozen step: loss not finite")
    expect_launches(launches, ENCODER_LAUNCHES, "frozen step")
    check(encoder_digest(model) == digest, "frozen step: the encoder moved")
    print(f"train, backbone frozen: loss {float(aux['loss']):.6f}, "
          f"{frozen_ms:.1f} ms (first such step), launches "
          f"{nonzero(launches)}")
    return total


def encoder_on_card(build, **kwargs) -> ImageEncoderViT:
    """An encoder built straight on the card (no CPU copy first) with the
    seeded weights, in ``eval()`` mode."""
    with torch.device("meta"):
        vit = build(**kwargs)
    vit = vit.to_empty(device="cuda")
    init_weights(vit, SEED)
    return vit.eval()


def cut_vit_h(project_last_hidden: bool, image_size: int,
              dtype: torch.dtype) -> ImageEncoderViT:
    """ViT-H at full width cut to 4 blocks, every second one global, so
    the CPU side of the slice parity stays short."""
    return ImageEncoderViT(
        img_size=image_size, patch_size=16, embed_dim=1280, depth=4,
        num_heads=HEADS_H, mlp_ratio=4, out_chans=256, qkv_bias=True,
        window_size=14, global_attn_indexes=(1, 3),
        project_last_hidden=project_last_hidden, dtype=dtype)


def phase_vit_h_parity() -> None:
    vit = encoder_on_card(build_vit_h, project_last_hidden=False)   # fp32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1024, 1024, 3), np.float32)).cuda()
    fa.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        out = vit(x)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        with fa.plain_attention():
            ref = vit(x)
        torch.cuda.synchronize()
    expect_launches(launches, ENCODER_LAUNCHES_H, "ViT-H parity")
    check(dict(fa.LAUNCHES) == launches,
          "a kernel was launched inside plain_attention()")
    check(tuple(out.shape) == (1, 64, 64, 1280)
          and bool(torch.isfinite(out).all()), "ViT-H output")
    print(f"ViT-H parity: fp32 encoder, 32 blocks, through the kernels "
          f"{kernel_s:.2f} s (first call); max |kernels - plain| "
          f"{(out - ref).abs().max().item():.3g} at scale "
          f"{ref.abs().max().item():.3g}; launches {nonzero(launches)}")
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=5e-4)
    del vit, out, ref
    torch.cuda.empty_cache()

    batch = random_batch(batch_size=1, num_examples=1, num_classes=2,
                         with_images=True, image_size=1024, seed=0)
    args = {k: v for k, v in CONFIG_H.items() if k != "name"}
    logits = {}
    for device in ("cuda", "cpu"):
        with torch.device("meta"):
            model = build_lam(build_vit=cut_vit_h, dtype="float32", **args)
        model = model.to_empty(device=device).eval()
        init_weights(model, SEED)
        fa.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model({k: torch.as_tensor(v, device=device)
                         for k, v in batch.items()})[ResultDict.LOGITS]
        if device == "cuda":
            torch.cuda.synchronize()
        logits[device] = out.float().cpu().numpy()
        expect_launches(dict(fa.LAUNCHES),
                        {"relpos_packed_global": 2, "relpos_packed_window": 2}
                        if device == "cuda" else {}, f"lam_h parity, {device}")
        print(f"lam_h parity: fp32 slice, encoder cut to 4 blocks, on "
              f"{device} {time.perf_counter() - t0:.2f} s")
        del model, out
    compare_logits(logits["cuda"], logits["cpu"], "lam_h parity")
    torch.cuda.empty_cache()


def phase_embed(build, name: str, per_call: dict, calls: int = 3,
                **options) -> dict:
    """``bench_vit``'s set-up: the encoder in bf16 with the SAM neck on a
    batch of standard-normal images, no gradient; ``options`` go to the
    builder."""
    vit = encoder_on_card(build, dtype=torch.bfloat16, **options)
    name += "".join(" " + o for o in options)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (EMBED_BATCH, 1024, 1024, 3), np.float32)).cuda().bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    times = []
    with torch.no_grad():
        for _ in range(1 + calls):
            t0 = time.perf_counter()
            out = vit(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    expect_launches(launches, {k: v * len(times) for k, v in per_call.items()},
                    f"embed {name}")
    check(tuple(out.shape) == (EMBED_BATCH, 64, 64, 256)
          and out.dtype == torch.bfloat16
          and bool(torch.isfinite(out).all()), f"embed {name}: output")
    ms = statistics.median(times[1:]) * 1e3
    print(f"embed {name}: {EMBED_BATCH} images a call, bf16, warm-up "
          f"{times[0] * 1e3:.1f} ms, calls "
          f"{[round(t * 1e3, 1) for t in times[1:]]} ms, median {ms:.1f} ms = "
          f"{EMBED_BATCH / ms * 1e3:.2f} images/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{nonzero(launches)}")
    del vit, out
    torch.cuda.empty_cache()
    return launches, EMBED_BATCH / ms * 1e3


def decode_batches(batch_size: int, include_masks: bool) -> list:
    """``bench_decode``'s two distinct episode batches (seeds 0 and 1)."""
    return [random_batch(batch_size=batch_size, num_examples=1,
                         num_classes=DECODE_CLASSES, image_size=480,
                         embed_dim=768, seed=seed, include_masks=include_masks)
            for seed in (0, 1)]


@contextlib.contextmanager
def fp32_twoway_kernel():
    """Inside this block ``TwoWayTransformer`` routes every call the fused
    kernel is compiled for to it, fp32 included, which its route rule
    sends the module path."""
    rule = ft.fused_twoway_ok
    ft.fused_twoway_ok = ft.fused_twoway_compiled
    try:
        yield
    finally:
        ft.fused_twoway_ok = rule


def phase_decode_parity() -> None:
    for include_masks in (True, False):
        what = "with masks" if include_masks else "without masks"
        batch = decode_batches(2, include_masks)[0]
        logits, forward_ms = {}, {}
        # fp32 takes the module path; "kernel" forces the fp32 kernel
        for name, device, extra, expected in (
                ("cuda", "cuda", {}, 0), ("cpu", "cpu", {}, 0),
                ("shared", "cuda", {"shared_keys": True}, 0),
                ("kernel", "cuda", {}, 2)):
            with (fp32_twoway_kernel() if name == "kernel"
                  else contextlib.nullcontext()):
                la = LabelAnything(dict(CONFIG_DECODE, dtype="float32",
                                        **extra), device, SEED)
                fa.reset_launches()
                t0 = time.perf_counter()
                out = la.predict(batch)
                if device == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                logits[name] = out.float().cpu().numpy()
                expect_launches(dict(fa.LAUNCHES), {"fused_twoway": expected},
                                f"decode parity ({name})")
                if name in ("cuda", "kernel"):
                    forward_ms[name] = 1e3 * statistics.median(
                        decode_steps(la, [batch, batch], 4)[0])
            print(f"decode parity, {what}: fp32 forward, {name}, "
                  f"{seconds:.2f} s, fused_twoway launches {expected}")
            del la
        compare_logits(logits["cuda"], logits["cpu"],
                       f"decode parity, {what}")
        compare_logits(logits["kernel"], logits["cpu"],
                       f"decode parity, {what}, the fp32 kernel forced")
        compare_logits(logits["shared"], logits["cuda"],
                       f"decode parity, {what}, shared keys against expanded")
        print(f"decode parity, {what}: fp32 forward of 2 episodes, median of "
              f"4: module path (the route) {forward_ms['cuda']:.2f} ms, the "
              f"fp32 kernel forced {forward_ms['kernel']:.2f} ms")


def decode_steps(la, batches, steps: int) -> tuple:
    """(seconds of each of ``steps`` forwards alternating the batches, each
    ended by a synchronize; the last step's logits)."""
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        out = la(batches[i % 2])[ResultDict.LOGITS]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out


def phase_decode() -> dict:
    la = LabelAnything(dict(CONFIG_DECODE, dtype="bf16"), seed=SEED)
    shared = LabelAnything(dict(CONFIG_DECODE, dtype="bf16", shared_keys=True),
                           seed=SEED)
    check(next(la.model.parameters()).is_cuda, "lam_no_vit is not on the card")
    total = {}
    s = CONFIG_DECODE["image_size"]
    valid_w = int(s * 0.9)
    for include_masks in (True, False):
        what = "with masks" if include_masks else "without masks"
        batches = [la.to_device(b)
                   for b in decode_batches(DECODE_BATCH, include_masks)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode_steps(la, batches, 1)
        fa.reset_launches()
        times, out = decode_steps(la, batches, DECODE_STEPS)
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        expect_launches(launches, {k: v * DECODE_STEPS
                                   for k, v in DECODE_LAUNCHES.items()},
                        f"decode {what}")
        check(tuple(out.shape) == (DECODE_BATCH, DECODE_CLASSES, s, s)
              and out.dtype == torch.bfloat16, f"decode logits {out.shape}")
        check(bool(torch.isfinite(out[..., :valid_w]).all()),
              "decode: non-finite logits in the valid region")
        check(bool((out[:, 0, :, valid_w:] == 0).all())
              and bool(torch.isneginf(out[:, 1:, :, valid_w:]).all()),
              "decode: pad fill")
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
        ms = statistics.median(times) * 1e3
        # the same steps through the module path and the shared-keys form
        with fa.plain_attention():
            decode_steps(la, batches, 1)
            before = dict(fa.LAUNCHES)
            plain_times, plain_out = decode_steps(la, batches, DECODE_STEPS)
            check(dict(fa.LAUNCHES) == before,
                  "a kernel was launched inside plain_attention()")
        decode_steps(shared, batches, 1)
        shared_times, shared_out = decode_steps(shared, batches, DECODE_STEPS)
        plain_ms = statistics.median(plain_times) * 1e3
        shared_ms = statistics.median(shared_times) * 1e3
        diffs = [(x.float() - out.float())[..., :valid_w].abs().max().item()
                 for x in (plain_out, shared_out)]
        print(f"decode {what}: {DECODE_BATCH} episodes a step, bf16, steps "
              f"{[round(t * 1e3, 2) for t in times]} ms, median {ms:.2f} ms = "
              f"{DECODE_BATCH / ms * 1e3:.1f} episodes/s; module path "
              f"(plain_attention) median {plain_ms:.2f} ms = "
              f"{DECODE_BATCH / plain_ms * 1e3:.1f} episodes/s; shared keys "
              f"median {shared_ms:.2f} ms = "
              f"{DECODE_BATCH / shared_ms * 1e3:.1f} episodes/s; peak memory "
              f"{peak / 2**30:.2f} GiB; launches a step "
              f"{ {k: v // DECODE_STEPS for k, v in nonzero(launches).items()} }"
              f"; max |logit difference| to the kernel path: module path "
              f"{diffs[0]:.3g}, shared keys {diffs[1]:.3g} (logit scale "
              f"{out[..., :valid_w].float().abs().max().item():.3g})")
        if include_masks:
            profile_steps(lambda: la(batches[0]), 4, unit="step")
            with fa.plain_attention():
                profile_steps(lambda: la(batches[0]), 4,
                              unit="module-path step")
    # the split entry points: the support set once, then the query
    batch = decode_batches(DECODE_BATCH, True)[0]
    support = {k: v[:, 1:] if k in (BatchKeys.EMBEDDINGS, BatchKeys.DIMS)
               else v for k, v in batch.items()}
    fa.reset_launches()
    embs = la.generate_class_embeddings(support)
    check(fa.LAUNCHES["fused_twoway"] == 1, "generate_class_embeddings: "
          "fused_twoway launches")
    split = la.predict(batch, embs)
    whole = la.predict(batch)
    torch.cuda.synchronize()
    expect_launches(dict(fa.LAUNCHES), {"fused_twoway": 4}, "decode, split")
    # the support set alone batches the neck's convolutions differently
    scale = whole[..., :valid_w].float().abs().max().item()
    diff = (split.float() - whole.float())[..., :valid_w].abs().max().item()
    print(f"decode: generate_class_embeddings + predict against the whole "
          f"forward: max |difference| {diff:.3g} at logit scale {scale:.3g}")
    check(diff <= 0.02 * scale, "decode: the split entry points and the "
          "whole forward differ")
    for name, count in fa.LAUNCHES.items():
        total[name] = total.get(name, 0) + count
    return total


def affinity_batches(batch_size: int, shots: int, classes: int,
                     seeds) -> list:
    """Episodes at 1024 px on SAM ViT-B embeddings (64 x 64 x 768) with
    mask prompts only, the configuration's validation prompts."""
    return [random_batch(batch_size=batch_size, num_examples=shots,
                         num_classes=classes, image_size=1024, embed_dim=768,
                         seed=seed, include_points=False, include_boxes=False)
            for seed in seeds]


def phase_affinity_parity() -> None:
    """The fp32 affinity slice on the card (K6) against the CPU (the twin)
    on 1 episode of 1-way 1-shot, whose classes are all flagged (a class
    with no flagged example has no finite logit, ROADMAP C4)."""
    batch = affinity_batches(1, 1, 2, (0,))[0]
    check(bool(batch[BatchKeys.FLAG_EXAMPLES].any(axis=1).all()),
          "affinity parity: the episode flags every class")
    logits = {}
    for device in ("cuda", "cpu"):
        la = LabelAnything(dict(CONFIG_AFFINITY, dtype="float32"), device,
                           SEED)
        fa.reset_launches()
        t0 = time.perf_counter()
        out = la.predict(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        logits[device] = out.float().cpu().numpy()
        expect_launches(dict(fa.LAUNCHES),
                        AFFINITY_LAUNCHES if device == "cuda" else {},
                        f"affinity parity ({device})")
        print(f"affinity parity: fp32 forward on {device} "
              f"{time.perf_counter() - t0:.2f} s")
        del la
    compare_logits(logits["cuda"], logits["cpu"], "affinity parity")


def check_affinity_logits(out: torch.Tensor, batch: dict, what: str) -> None:
    """Logits (B, C, S, S) in bf16: a flagged class finite in the valid
    region with the pad fill (0 background, -inf other classes); a class no
    example flags with no finite value."""
    s = CONFIG_AFFINITY["image_size"]
    valid_w = int(s * 0.9)
    flagged = batch[BatchKeys.FLAG_EXAMPLES].bool().any(dim=1)
    check(tuple(out.shape) == (AFFINITY_BATCH, AFFINITY_CLASSES, s, s)
          and out.dtype == torch.bfloat16, f"{what}: logits {out.shape}")
    check(bool(torch.isfinite(out[flagged][..., :valid_w]).all()),
          f"{what}: non-finite logits in the valid region of a flagged class")
    check(bool((out[:, 0, :, valid_w:] == 0).all())
          and bool(torch.isneginf(out[:, 1:][flagged[:, 1:]][..., valid_w:])
                   .all()), f"{what}: pad fill")
    check(not bool(torch.isfinite(out[~flagged]).any()),
          f"{what}: finite logits for a class no example flags")


def phase_affinity() -> dict:
    """Serving traffic of the affinity decoder: 2 episodes of 2-way 1-shot
    a forward (val_coco20i_N2K1 at the configuration's validation batch),
    two batches alternating, 1 warm-up and AFFINITY_STEPS timed forwards;
    a profiler pass; the same forwards inside ``plain_attention()``."""
    la = LabelAnything(dict(CONFIG_AFFINITY, dtype="bf16"), seed=SEED)
    check(next(la.model.parameters()).is_cuda, "the affinity model is not on "
          "the card")
    batches = [la.to_device(b) for b in affinity_batches(
        AFFINITY_BATCH, AFFINITY_SHOTS, AFFINITY_CLASSES, (2, 3))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_steps(la, batches, 1)
    fa.reset_launches()
    times, out = decode_steps(la, batches, AFFINITY_STEPS)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launches, {k: v * AFFINITY_STEPS
                               for k, v in AFFINITY_LAUNCHES.items()},
                    "affinity decode")
    last = batches[(AFFINITY_STEPS - 1) % 2]
    check_affinity_logits(out, last, "affinity decode")
    ms = statistics.median(times) * 1e3
    with fa.plain_attention():
        decode_steps(la, batches, 1)
        before = dict(fa.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        plain_times, plain_out = decode_steps(la, batches, AFFINITY_STEPS)
        plain_peak = torch.cuda.max_memory_allocated()
        check(dict(fa.LAUNCHES) == before,
              "a kernel was launched inside plain_attention()")
    check_affinity_logits(plain_out, last, "affinity decode, plain")
    flagged = last[BatchKeys.FLAG_EXAMPLES].bool().any(dim=1)
    valid_w = int(CONFIG_AFFINITY["image_size"] * 0.9)
    region = lambda x: x[flagged][..., :valid_w].float()
    diff = (region(plain_out) - region(out)).abs().max().item()
    plain_ms = statistics.median(plain_times) * 1e3
    print(f"affinity decode: {AFFINITY_BATCH} episodes of "
          f"{AFFINITY_CLASSES - 1}-way 1-shot a forward, bf16, forwards "
          f"{[round(t * 1e3, 2) for t in times]} ms, median {ms:.2f} ms = "
          f"{AFFINITY_BATCH / ms * 1e3:.2f} episodes/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches a forward "
          f"{ {k: v // AFFINITY_STEPS for k, v in nonzero(launches).items()} }"
          f"; inside plain_attention() median {plain_ms:.2f} ms = "
          f"{AFFINITY_BATCH / plain_ms * 1e3:.2f} episodes/s, peak "
          f"{plain_peak / 2**30:.2f} GiB, max |logit difference| to the "
          f"kernel path {diff:.3g} (logit scale "
          f"{region(out).abs().max().item():.3g})")
    profile_steps(lambda: la(batches[0]), 2, unit="forward")
    return launches


def phase_options_parity() -> None:
    """fp32: ``lam_b`` with ``fused_window=True`` on the card against the
    CPU and against the unfused card run; ``build_vit_h`` with the option
    against ``plain_attention()``; one training pass with the option
    against the unfused pass."""
    batch = random_batch(batch_size=1, num_examples=1, num_classes=2,
                         with_images=True, image_size=1024, seed=0)
    fused = dict(CONFIG, dtype="float32", fused_window=True)
    logits = {}
    for name, config, device, expected in (
            ("card", fused, "cuda", FUSED_LAUNCHES),
            ("cpu", fused, "cpu", {}),
            ("unfused", dict(CONFIG, dtype="float32"), "cuda",
             ENCODER_LAUNCHES)):
        la = LabelAnything(config, device, SEED)
        fa.reset_launches()
        t0 = time.perf_counter()
        out = la.predict(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        logits[name] = out.float().cpu().numpy()
        expect_launches(dict(fa.LAUNCHES), expected,
                        f"options parity ({name})")
        print(f"options parity: fp32 lam_b forward, {name}, "
              f"{time.perf_counter() - t0:.2f} s, launches "
              f"{nonzero(dict(fa.LAUNCHES))}")
        del la
    compare_logits(logits["card"], logits["cpu"],
                   "options parity, fused_window, card against CPU")
    compare_logits(logits["card"], logits["unfused"],
                   "options parity, fused_window against unfused on the card")

    vit = encoder_on_card(build_vit_h, project_last_hidden=False,
                          fused_window=True)                         # fp32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1024, 1024, 3), np.float32)).cuda()
    fa.reset_launches()
    with torch.no_grad():
        out = vit(x)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        with fa.plain_attention():
            ref = vit(x)
        torch.cuda.synchronize()
    expect_launches(launches, FUSED_LAUNCHES_H, "options parity, ViT-H")
    check(dict(fa.LAUNCHES) == launches,
          "a kernel was launched inside plain_attention()")
    print(f"options parity: fp32 ViT-H encoder with fused_window, 32 blocks, "
          f"max |kernels - plain| {(out - ref).abs().max().item():.3g} at "
          f"scale {ref.abs().max().item():.3g}; launches {nonzero(launches)}")
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=5e-4)
    del vit, out, ref
    torch.cuda.empty_cache()

    batch, gt = training_batch(batch_size=1, shots=1)
    runs = {}
    for name, config, expected in (
            ("fused", dict(CONFIG, fused_window=True),
             {"relpos_global": 4, "relpos_global_bwd": 4, "fused_window": 8}),
            ("unfused", CONFIG, TRAIN_LAUNCHES)):
        fa.reset_launches()
        runs[name] = gradient_pass("float32", batch, gt, config=config)
        expect_launches(dict(fa.LAUNCHES), expected,
                        f"options parity, training pass ({name})")
    (_, loss_f, grads_f), (_, loss_u, grads_u) = runs["fused"], runs["unfused"]
    compare_gradients(loss_f, grads_f, loss_u, grads_u,
                      "options parity, fp32 training pass", "fused_window",
                      "unfused")
    del runs, grads_f, grads_u
    torch.cuda.empty_cache()


def phase_options_serve(logits_full: torch.Tensor) -> list:
    """bf16: ``lam_b`` requests with each option beside phase 4's; the
    encoders embedding with ``fused_window`` on beside off. Returns the
    paths' launches."""
    paths = []
    launches, fused = phase_serve(dict(CONFIG, fused_window=True),
                                  FUSED_LAUNCHES, profile=True)
    paths.append(launches)
    launches, int8 = phase_serve(dict(CONFIG, int8_scores=True),
                                 INT8_LAUNCHES)
    paths.append(launches)
    finite = torch.isfinite(logits_full)
    # with the seeded weights the two classes' logits lie close: the
    # foreground-background margin of phase 4's request, where both are
    # finite, says how far a logit may move before the argmax flips
    full = logits_full.float()
    margin = (full[:, 1] - full[:, 0])[finite.all(dim=1)].abs()
    for name, out in (("fused_window", fused), ("int8_scores", int8)):
        check(torch.equal(torch.isfinite(out), finite),
              f"serve {name}: finite masks differ")
        agree = (out.float().argmax(1) == full.argmax(1)).float().mean().item()
        diff = (out.float() - full)[finite].abs().max().item()
        print(f"serve lam_b {name} against phase 4's request (bf16): argmax "
              f"agreement {agree:.6f}, max |logit difference| {diff:.3g} "
              f"(logit scale {full[finite].abs().max().item():.3g}; median "
              f"|class margin| of phase 4's request "
              f"{margin.median().item():.3g})")
    rates = {}
    for build, name, off, on in (
            (build_vit_b, "vit_b", ENCODER_LAUNCHES, FUSED_LAUNCHES),
            (build_vit_l, "vit_l", ENCODER_LAUNCHES_L, FUSED_LAUNCHES_L),
            (build_vit_h, "vit_h", ENCODER_LAUNCHES_H, FUSED_LAUNCHES_H)):
        launches, rate_off = phase_embed(build, name, off, calls=2)
        paths.append(launches)
        launches, rate_on = phase_embed(build, name, on, calls=2,
                                        fused_window=True)
        paths.append(launches)
        rates[name] = (rate_on, rate_off)
    print("embed with fused_window on / off, images/s: " + ", ".join(
        f"{name} {on:.2f} / {off:.2f}" for name, (on, off) in rates.items()))
    return paths


def phase_golden() -> None:
    """The full-size golden fixtures through the port on the card (fp32),
    at the cases' own tolerances; the SAM case with the fused windowed
    block off and on."""
    for name, options, expected in (
            ("canonical_full_forward", {}, {}),
            ("sam_released_full_forward", {}, ENCODER_LAUNCHES),
            ("sam_released_full_forward", {"fused_window": True},
             FUSED_LAUNCHES)):
        fa.reset_launches()
        t0 = time.perf_counter()
        ours, ref = replay(name, "cuda", **options)
        expect_launches(dict(fa.LAUNCHES), expected, f"golden {name}")
        CASES[name].compare(ours, ref)
        finite = np.isfinite(ref["strided"])
        diff = np.abs(ours["strided"][finite] - ref["strided"][finite]).max()
        agree = (ours["argmax"] == ref["argmax"]).mean()
        print(f"golden {name}{''.join(' ' + o for o in options)}: fp32 on "
              f"the card {time.perf_counter() - t0:.2f} s, max |port - "
              f"reference| {diff:.3g} on the stored logits (scale "
              f"{np.abs(ref['strided'][finite]).max():.3g}), argmax agreement "
              f"{agree:.6f}; launches {nonzero(dict(fa.LAUNCHES))}")
    torch.cuda.empty_cache()


# phase 17: the JAX bench_train's configuration, mae.yaml's train_params:
# 8 episodes of 5-way 1-shot a step (one example image, 6 classes with the
# background), bf16; the prompt encoder's fusion runs 8 x 1 x 6 = 48
# instances of K7, the mask decoder's 8
FLAGSHIP_BATCH, FLAGSHIP_CLASSES, FLAGSHIP_STEPS = 8, 6, 8
FLAGSHIP_LAUNCHES = {"fused_twoway": 2}    # a step, both call sites
FLAGSHIP_ROWS = (0, 7, 3, 9, 5, 1)         # class rows of the fp32 pass
# the train_params of both configurations: AdamW 5e-5 (train_state) after
# 1000 warm-up steps
SCHEDULE = {"name": "constant_with_warmup", "num_warmup_steps": 1000}
# phase 18: possible_batch_example_nums of 4.2_Affinity_SAM.yaml, (episodes,
# ways, shots): ways x shots example images an episode, ways + 1 classes
AFFINITY_TUPLES = [(1, 1, 4), (1, 4, 2), (2, 1, 2), (2, 2, 2), (2, 4, 1),
                   (4, 1, 1)]
AFFINITY_TRAIN_STEPS = 4
AFFINITY_TRAIN_LAUNCHES = {"flash": 2}    # a step: the forward's 2 blocks


def embedding_episodes(batch_size: int, ways: int, shots: int,
                       image_size: int, include_masks: bool = True,
                       seed: int = 0, every_class: bool = False,
                       embeddings=None):
    """A training batch on 768-wide precomputed embeddings: ``batch_size``
    episodes of ``ways``-way ``shots``-shot (``random_full_batch``, ways x
    shots example images, or 1 where ``every_class`` is False, as
    ``bench_train`` makes them) through ``Substitutor(num_points=1,
    substitute=False)``, on the card. ``embeddings`` (B, M + 1, h, w, 768)
    replace the random ones."""
    examples = ways * shots if every_class else shots
    full = random_full_batch(batch_size=batch_size, num_examples=examples,
                             num_classes=ways + 1, image_size=image_size,
                             embed_dim=768, include_masks=True, seed=seed)
    if every_class:
        full = flag_every_class(full, shots)
    if not include_masks:
        full = {k: v for k, v in full.items()
                if k not in (BatchKeys.PROMPT_MASKS, BatchKeys.FLAG_MASKS)}
    full = {k: torch.as_tensor(v) for k, v in full.items()}
    if embeddings is not None:
        full[BatchKeys.EMBEDDINGS] = torch.as_tensor(embeddings).cpu()
    sub = Substitutor(num_points=1, substitute=False)
    sub.reset(full)
    batch, gt = next(sub)
    return {k: v.cuda() for k, v in batch.items()}, gt.cuda()


def zero_gradient(grads: dict) -> set:
    """Parameters a pass gives no gradient, or one of exactly zero, and
    those whose gradient is zero up to rounding (ZERO_GRADIENT)."""
    return {n for n, g in grads.items()
            if g is None or not bool(g.any()) or n.endswith(ZERO_GRADIENT)}


def train_steps(state, batches, steps: int, generator) -> tuple:
    """1 warm-up and ``steps`` timed training steps alternating
    ``batches`` [(batch, gt)], each ended by a synchronize, the class rows
    drawn from ``generator`` (seeded once): (seconds, losses, launches a
    timed step)."""
    step = make_train_step()
    generator.manual_seed(SEED)
    times, losses, per_step = [], [], []
    for i in range(1 + steps):
        batch, gt = batches[i % len(batches)]
        fa.reset_launches()
        t0 = time.perf_counter()
        state, aux = step(state, batch, gt, generator, 1.0,
                          apply_update=True, use_accum=False)
        losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(dict(fa.LAUNCHES))
    return times[1:], losses, per_step[1:]


def check_moved(model, before: dict, still: set, what: str) -> None:
    """Every parameter finite, and every one outside ``still`` moved."""
    unchanged = []
    for name, p in model.named_parameters():
        check(bool(torch.isfinite(p).all()), f"{what}: {name} not finite")
        if torch.equal(p, before[name]):
            unchanged.append(name)
    check(set(unchanged) <= still,
          f"{what}: parameters that did not move: "
          f"{sorted(set(unchanged) - still)}")
    print(f"{what}: {len(unchanged)} of {len(before)} parameters did not "
          f"move, each with no gradient in the fp32 pass")


def phase_flagship() -> dict:
    """Phase 17: training ``lam_no_vit`` on precomputed embeddings in the
    JAX ``bench_train``'s configuration."""
    batch, gt = embedding_episodes(FLAGSHIP_BATCH, FLAGSHIP_CLASSES - 1, 1,
                                   480)
    # fp32: K7 forced (its rule admits bf16 only) against the module path
    runs, still = {}, {}
    for mode in ("kernels", "plain"):
        fa.reset_launches()
        t0 = time.perf_counter()
        with (fp32_twoway_kernel() if mode == "kernels"
              else fa.plain_attention()):
            runs[mode] = gradient_pass("float32", batch, gt,
                                       config=CONFIG_DECODE,
                                       rows=FLAGSHIP_ROWS)
        expect_launches(dict(fa.LAUNCHES),
                        FLAGSHIP_LAUNCHES if mode == "kernels" else {},
                        f"flagship step parity ({mode})")
        print(f"flagship step parity: fp32 pass through the {mode} "
              f"{time.perf_counter() - t0:.2f} s, loss {runs[mode][1]:.6f}")
    (_, loss_k, grads_k), (_, loss_p, grads_p) = runs["kernels"], runs["plain"]
    compare_gradients(loss_k, grads_k, loss_p, grads_p, "flagship step "
                      "parity", "kernels", "plain", rel_pos_tables=0)
    still[True] = zero_gradient(grads_k)
    nomask = embedding_episodes(FLAGSHIP_BATCH, FLAGSHIP_CLASSES - 1, 1, 480,
                                include_masks=False)
    still[False] = zero_gradient(gradient_pass(
        "float32", *nomask, config=CONFIG_DECODE, rows=FLAGSHIP_ROWS)[2])
    del runs, grads_k, grads_p

    total = {}
    generator = torch.Generator()
    for extra, masks in (({}, True), ({}, False), ({"shared_keys": True},
                                                   True)):
        what = ("flagship, " + ("with masks" if masks else "without masks")
                + "".join(f", {k}" for k in extra))
        batches = [embedding_episodes(FLAGSHIP_BATCH, FLAGSHIP_CLASSES - 1,
                                      1, 480, include_masks=masks,
                                      seed=seed) for seed in (0, 1)]
        state = train_state("bf16", dict(CONFIG_DECODE, **extra),
                            scheduler=SCHEDULE)
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses, per_step = train_steps(state, batches, FLAGSHIP_STEPS,
                                              generator)
        peak = torch.cuda.max_memory_allocated()
        expected = ({"fused_twoway": 1} if extra else FLAGSHIP_LAUNCHES)
        for launches in per_step:
            expect_launches(launches, expected, what)
        check(all(np.isfinite(x) for x in losses), f"{what}: losses {losses}")
        check_moved(state.model, before, still[masks], what)
        ms = statistics.median(times) * 1e3
        if masks and not extra:
            FLAGSHIP_RATE["masks"] = FLAGSHIP_BATCH / ms * 1e3
        print(f"{what}: {FLAGSHIP_BATCH} episodes of "
              f"{FLAGSHIP_CLASSES - 1}-way 1-shot a step, bf16, losses "
              f"{[round(x, 5) for x in losses]}; steps "
              f"{[round(t * 1e3, 2) for t in times]} ms, median {ms:.2f} ms "
              f"= {FLAGSHIP_BATCH / ms * 1e3:.1f} episodes/s; peak memory "
              f"{peak / 2**30:.2f} GiB; launches a step "
              f"{nonzero(per_step[-1])}")
        if not extra:
            for name, count in per_step[-1].items():
                total[name] = total.get(name, 0) + count * len(per_step)
        if masks and not extra:
            capacity = ft.cluster_capacity(torch.device("cuda"))
            print(f"flagship: K7 takes clusters of "
                  f"{ft.twoway_cluster(FLAGSHIP_BATCH * FLAGSHIP_CLASSES, 900, capacity)}"
                  f" blocks at the prompt encoder's "
                  f"{FLAGSHIP_BATCH * FLAGSHIP_CLASSES} instances, "
                  f"{ft.twoway_cluster(FLAGSHIP_BATCH, 900, capacity)} at the "
                  f"mask decoder's {FLAGSHIP_BATCH}")

            def one_step(state=state, batch=batches[0]):
                generator.manual_seed(SEED)
                make_train_step()(state, *batch, generator, 1.0,
                                  apply_update=True, use_accum=False)

            profile_steps(one_step, 2)
        del state, before
        torch.cuda.empty_cache()
    return total


def affinity_tuple_step(state, ways: int, shots: int, episodes: int,
                        generator, steps: int) -> dict:
    """fp32 training steps of the affinity model at one tuple of the
    configuration: peak memory, step times, losses."""
    batch = embedding_episodes(episodes, ways, shots, 1024, seed=ways + shots,
                               every_class=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, losses, per_step = train_steps(state, [batch], steps, generator)
    peak = torch.cuda.max_memory_allocated()
    for launches in per_step:
        expect_launches(launches, AFFINITY_TRAIN_LAUNCHES,
                        f"affinity training {(episodes, ways, shots)}")
    check(all(np.isfinite(x) for x in losses), f"losses {losses}")
    return dict(peak_gib=peak / 2**30, losses=losses,
                ms=statistics.median(times) * 1e3)


def phase_affinity_train() -> dict:
    """Phase 18: training the affinity model (4.2_Affinity_SAM.yaml's model
    block and train_params)."""
    # fp32 parity at 1 episode of 1-way 1-shot: K6 against the twin, the
    # twin with fp64 scores as the second reference, and K6 in bf16 as the
    # control that the rules must refuse
    batch, gt = embedding_episodes(1, 1, 1, 1024, seed=4, every_class=True)
    flash = fa.flash_attention
    bf16_flash = lambda q, k, v, scale: flash(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), scale).to(q.dtype)
    modes = {"kernels": contextlib.nullcontext,
             "plain": fa.plain_attention,
             "plain_fp64": lambda: fa.plain_attention(scores=torch.float64),
             "kernels_bf16": lambda: mock.patch.object(
                 fa, "flash_attention", bf16_flash)}
    runs, signs = {}, {}
    for mode, context in modes.items():
        fa.reset_launches()
        t0 = time.perf_counter()
        with context():
            runs[mode] = gradient_pass("float32", batch, gt,
                                       config=CONFIG_AFFINITY, rows=(0, 7),
                                       signs=signs.setdefault(mode, {}))
        expect_launches(dict(fa.LAUNCHES), {} if mode.startswith("plain")
                        else AFFINITY_TRAIN_LAUNCHES,
                        f"affinity step parity ({mode})")
        print(f"affinity step parity: fp32 pass through the {mode} "
              f"{time.perf_counter() - t0:.2f} s, loss {runs[mode][1]:.6f}")
    units = sum(x.numel() for v in signs["plain"].values() for x in v)
    flips = {m: flipped_units(signs[m], signs["plain"])
             for m in ("kernels", "plain_fp64", "kernels_bf16")}
    print(f"affinity step parity: of {units} ReLU units the plain pass's "
          f"sign flips in " + ", ".join(f"{n} ({m})"
                                        for m, n in flips.items()))
    verdict = compare_gradients(
        runs["kernels"][1], runs["kernels"][2], runs["plain"][1],
        runs["plain"][2], "affinity step parity", "kernels", "plain",
        rel_pos_tables=0, floors=runs["plain_fp64"][2],
        flips=(flips["kernels"], flips["plain_fp64"]))
    control = gradient_verdict(
        runs["kernels_bf16"][1], runs["kernels_bf16"][2], runs["plain"][1],
        runs["plain"][2], floors=runs["plain_fp64"][2],
        flips=(flips["kernels_bf16"], flips["plain_fp64"]))
    for rel, key, norm, allowed in control["rows"][:3]:
        print(f"affinity step parity, control (K6 in bf16): relative L2 "
              f"{rel:.3g} (allowed {allowed:.3g}, norm {norm:.3g}) {key}")
    print(f"affinity step parity, control: loss {runs['kernels_bf16'][1]:.8f}"
          f", relative L2 of the whole {control['whole']:.3g} (kernels "
          f"{verdict['whole']:.3g}); refused: {control['why']}")
    check(not control["ok"], "affinity step parity: the rules do not refuse "
          "K6 in bf16")
    del runs, signs
    # fp32 at every tuple, K6's backward recomputing in RECOMPUTE_BYTES
    # blocks as the port runs it: every tuple must fit
    generator = torch.Generator()
    state = train_state("float32", CONFIG_AFFINITY, scheduler=SCHEDULE)
    for episodes, ways, shots in AFFINITY_TUPLES:
        rec = affinity_tuple_step(state, ways, shots, episodes, generator, 2)
        print(f"affinity training, fp32, {[episodes, ways, shots]} "
              f"(episodes, ways, shots): peak memory {rec['peak_gib']:.2f} "
              f"GiB, step {rec['ms']:.1f} ms = "
              f"{episodes / rec['ms'] * 1e3:.2f} episodes/s, losses "
              f"{[round(x, 6) for x in rec['losses']]}")
    del state
    torch.cuda.empty_cache()

    # bf16 at (2, 2, 2)
    episodes, ways, shots = 2, 2, 2
    state = train_state("bf16", CONFIG_AFFINITY, scheduler=SCHEDULE)
    batches = [embedding_episodes(episodes, ways, shots, 1024, seed=seed,
                                  every_class=True) for seed in (20, 21)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, per_step = train_steps(state, batches,
                                          AFFINITY_TRAIN_STEPS, generator)
    peak = torch.cuda.max_memory_allocated()
    for launches in per_step:
        expect_launches(launches, AFFINITY_TRAIN_LAUNCHES,
                        "affinity training bf16")
    check(all(np.isfinite(x) for x in losses), f"losses {losses}")
    ms = statistics.median(times) * 1e3
    print(f"affinity training, bf16, {[episodes, ways, shots]}: steps "
          f"{[round(t * 1e3, 1) for t in times]} ms, median {ms:.1f} ms = "
          f"{episodes / ms * 1e3:.2f} episodes/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches a step {nonzero(per_step[-1])}")
    profile_steps(lambda: make_train_step()(
        state, *batches[0], generator, 1.0, apply_update=True,
        use_accum=False), 2)
    return {name: count * len(per_step)
            for name, count in per_step[-1].items()}


# phase 19: 16 seeded images of two sizes (height, width), embedded with
# build_vit_b in batches of 8; the affinity steps take 2 episodes of 2-way
# 1-shot from the caches (3 images an episode), saved after step 2
WORKFLOW_SIZES = [(480, 640), (1024, 683)]
WORKFLOW_IMAGES, WORKFLOW_BATCH, WORKFLOW_STEPS = 16, 8, 4
WORKFLOW_DIR = "build/workflow"
# launches of one build_vit_b call on a batch (4 global, 8 windowed blocks)
WORKFLOW_LAUNCHES = {"relpos_global": 4, "relpos_window": 8}


def workflow_images() -> list:
    rng = np.random.default_rng(SEED)
    return [(str(i + 1), rng.integers(
        0, 256, WORKFLOW_SIZES[i % 2] + (3,), dtype=np.uint8))
        for i in range(WORKFLOW_IMAGES)]


def workflow_episodes(caches: list, step: int, generator=None):
    """Step ``step``'s batch: 2 episodes of 2-way 1-shot whose 6 images are
    caches 6 step, 6 step + 1, ... (mod 16), with their own sizes as
    ``dims``."""
    picks = [(6 * step + j) % len(caches) for j in range(6)]
    emb = torch.stack([caches[i][1] for i in picks]).reshape(
        2, 3, *caches[0][1].shape)
    batch, gt = embedding_episodes(2, 2, 1, 1024, seed=10 + step,
                                   every_class=True, embeddings=emb)
    dims = torch.tensor([caches[i][2] for i in picks],
                        dtype=torch.int32).reshape(2, 3, 2)
    batch[BatchKeys.DIMS] = dims.cuda()
    # the query's pad region is no class, as a loader's ground truth has it
    for b, (h, w) in enumerate(dims[:, 0].tolist()):
        ih, iw = get_preprocess_shape(h, w, 1024)
        gt[b, ih:] = IGNORE_INDEX
        gt[b, :, iw:] = IGNORE_INDEX
    return batch, gt


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms where torch has them (cuDNN included),
    warnings for the ops that have none."""
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = cudnn


def phase_workflow() -> dict:
    """Phase 19: embed images into the reference's cache with
    ``preprocess_images_to_embeddings`` (``build_vit_b``, the last block's
    state too), read the last-block caches back, train the affinity model
    on them with a checkpoint and a resume, save and reload the model, and
    serve it at the images' own sizes."""
    import shutil

    from labelanything_tpu_torch.api import LabelAnything as LA
    from labelanything_tpu_torch.data.embeddings import load_embedding
    from labelanything_tpu_torch.inference import predict_original_resolution
    from labelanything_tpu_torch.preprocess import (cache_name, load_one,
                                                    normalize,
                                                    preprocess_images_to_embeddings,
                                                    save_st)
    from labelanything_tpu_torch.train.checkpoint import CheckpointManager

    shutil.rmtree(WORKFLOW_DIR, ignore_errors=True)
    out_dir = WORKFLOW_DIR + "/embeddings"
    last_dir = out_dir + "_last"
    images = workflow_images()
    embed = lambda items, folder: preprocess_images_to_embeddings(
        "vit_b", items, batch_size=WORKFLOW_BATCH, num_workers=8,
        outfolder=folder, last_block_dir=folder + "_last", dtype="bf16",
        seed=SEED)
    # a warm-up batch first, so that the timed pass's first batch runs as
    # its later ones do
    embed(images[:WORKFLOW_BATCH], WORKFLOW_DIR + "/warm")
    fa.reset_launches()
    rate = embed(images, out_dir)
    launches = dict(fa.LAUNCHES)
    batches = WORKFLOW_IMAGES // WORKFLOW_BATCH
    expect_launches(launches, {k: v * batches
                               for k, v in WORKFLOW_LAUNCHES.items()},
                    "preprocess")
    print(f"workflow: preprocess_images_to_embeddings build_vit_b bf16, "
          f"{WORKFLOW_IMAGES} images of {WORKFLOW_SIZES} in batches of "
          f"{WORKFLOW_BATCH} after a warm-up batch: {rate:.2f} images/s "
          f"(resize on the host, writes included); launches "
          f"{nonzero(launches)}")
    # the host's part: resize and pad, and one image's two cache files
    # written as the pass writes them (channels-last output, transposed),
    # each timed alone on one thread
    for size in WORKFLOW_SIZES:
        item = next(x for x in images if x[1].shape[:2] == size)
        t0 = time.perf_counter()
        loaded = load_one(item, 1024, True)
        t1 = time.perf_counter()
        for channels, folder in ((256, "/host"), (768, "/host_last")):
            out = np.zeros((64, 64, channels), np.float32)
            save_st({"embedding": out.transpose(2, 0, 1)},
                    f"{WORKFLOW_DIR}{folder}.safetensors")
        t2 = time.perf_counter()
        print(f"workflow: host per image of {size}: resize to "
              f"{loaded[2]} and pad {(t1 - t0) * 1e3:.1f} ms, write both "
              f"caches {(t2 - t1) * 1e3:.1f} ms")

    # the caches against the encoder's own output on the same batches
    vit = encoder_on_card(build_vit_b, dtype=torch.bfloat16)
    caches, worst = [], 0.0
    for start in range(0, WORKFLOW_IMAGES, WORKFLOW_BATCH):
        loaded = [load_one(item, 1024, True)
                  for item in images[start:start + WORKFLOW_BATCH]]
        x = torch.from_numpy(np.stack([c[1] for c in loaded])).cuda()
        hw = torch.tensor([c[2] for c in loaded], device="cuda")
        with torch.no_grad():
            want = vit(normalize(x, hw), return_last_block_state=True)
        for i, (image_id, _, _) in enumerate(loaded):
            hidden = load_embedding(f"{out_dir}/{cache_name(image_id)}")
            last = load_embedding(f"{last_dir}/{cache_name(image_id)}")
            check(tuple(hidden.shape) == (64, 64, 256)
                  and tuple(last.shape) == (64, 64, 768)
                  and hidden.dtype == last.dtype == torch.float32,
                  f"cache {image_id}: {hidden.shape} {last.shape}")
            for got, ref in ((hidden, want["last_hidden_state"][i]),
                             (last, want["last_block_state"][i])):
                worst = max(worst, (got.cuda() - ref.float()).abs().max()
                            .item())
            caches.append((image_id, last,
                           images[int(image_id) - 1][1].shape[:2]))
    check(worst == 0.0, f"the caches differ from the encoder's output by "
          f"{worst}")
    print(f"workflow: {len(caches)} caches read back (channels-last, "
          f"fp32), equal to the encoder's output bit for bit")
    del vit

    # affinity training on the caches, fp32: 4 steps straight, then the
    # same from the checkpoint saved after step 2
    ckpt = CheckpointManager(WORKFLOW_DIR + "/checkpoints",
                             watch_metric="loss", higher_is_better=False)
    runs = {}
    with deterministic():
        for mode in ("straight", "resumed"):
            state = train_state("float32", CONFIG_AFFINITY,
                                scheduler=SCHEDULE)
            generator = torch.Generator().manual_seed(SEED)
            first = 0
            if mode == "resumed":
                state, meta = ckpt.restore(state, generator=generator)
                check(state is not None and state.step == 2
                      and meta["epoch"] == 0, f"restore: {meta}")
                first = 2
            step, losses = make_train_step(), []
            fa.reset_launches()
            for i in range(first, WORKFLOW_STEPS):
                state, aux = step(state, *workflow_episodes(caches, i),
                                  generator, 1.0, apply_update=True,
                                  use_accum=False)
                losses.append(float(aux["loss"]))
                if mode == "straight" and i == 1:
                    ckpt.save_latest(state, epoch=0, generator=generator)
                    ckpt.maybe_save_best(state, 0, losses[-1],
                                         generator=generator)
            torch.cuda.synchronize()
            expect_launches(dict(fa.LAUNCHES),
                            {"flash": 2 * (WORKFLOW_STEPS - first)},
                            f"workflow training ({mode})")
            runs[mode] = (state, losses)
    (straight, losses), (resumed, losses_r) = runs["straight"], runs["resumed"]
    check(all(np.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[2:] == losses_r, f"resumed losses {losses_r} against "
          f"{losses[2:]}")
    theirs = resumed.model.state_dict()
    for key, value in straight.model.state_dict().items():
        check(torch.equal(value, theirs[key]), f"resume: {key} differs")
    print(f"workflow: affinity training on the caches, fp32, 2 episodes "
          f"of 2-way 1-shot a step, losses {[round(x, 6) for x in losses]}; "
          f"resumed after step 2: steps 3 and 4 {losses_r}, every "
          f"parameter equal bit for bit; best checkpoint at loss "
          f"{ckpt.best_value:.6f}")

    # save, reload, serve at the images' own sizes
    la = LA(dict(CONFIG_AFFINITY, dtype="float32"), seed=None)
    la.load_state_dict(straight.model.state_dict())
    la.save_pretrained(WORKFLOW_DIR + "/pretrained")
    again = LA.from_pretrained(WORKFLOW_DIR + "/pretrained")
    batch, _ = workflow_episodes(caches, 0)
    fa.reset_launches()
    here = predict_original_resolution(la, batch)
    there = predict_original_resolution(again, batch)
    torch.cuda.synchronize()
    expect_launches(dict(fa.LAUNCHES), {"flash": 4}, "workflow serving")
    sizes = batch[BatchKeys.DIMS][:, 0].tolist()
    check(tuple(here.shape) == (2, 3, max(h for h, _ in sizes),
                                max(w for _, w in sizes)),
          f"original-resolution logits {here.shape} for sizes {sizes}")
    for i, (h, w) in enumerate(sizes):
        check(bool(torch.isfinite(here[i, :, :h, :w]).all()),
              f"episode {i}: non-finite logits at its own size")
    check(torch.equal(here, there), "from_pretrained serves other logits")
    print(f"workflow: save_pretrained / from_pretrained, "
          f"predict_original_resolution at the queries' sizes {sizes}: "
          f"logits {tuple(here.shape)}, the reloaded model's equal bit for "
          f"bit")
    shutil.rmtree(WORKFLOW_DIR, ignore_errors=True)
    return launches, rate


# phase 20: the training entry point (CLI, Run, the episode engine on
# embedding caches) with parameters/trainval/coco20i/mae.yaml itself on a
# synthetic COCO root of MAE_IMAGES images; cut to one epoch of MAE_STEPS
# steps and MAE_VAL validation episodes a set
MAE_YAML = "parameters/trainval/coco20i/mae.yaml"
MAE_DIR = "build/mae_run"
MAE_IMAGES, MAE_STEPS, MAE_VAL = 288, 48, 64
MAE_PROFILE_STEPS = 4
# the card's Run against the CPU's, fp32, from the same weights on the same
# batches at mae.yaml's learning rate held constant (its 1000 warm-up steps
# taken out, so that the steps move the weights): MAE_PARITY_STEPS steps,
# each step's loss within MAE_LOSS_RTOL (relative); the AdamW first moments
# after the first step (a tenth of its gradients, from the same weights)
# under phase 5's rule per parameter at MAE_MOMENT_REL_L2, phase 3's
# tolerance of the card against the CPU (those whose gradient is zero in
# exact arithmetic, as exact_zero_gradient names them, under GRAD_FLOOR of
# the whole on both sides), and after the run (the running mean of the steps'
# gradients) within GRAD_REL_L2 as one vector; the parameters' change from
# the start as one vector within a relative L2 distance of MAE_CHANGE_REL_L2
# (AdamW divides each element's gradient by that element's own scale, so an
# element's rounding counts in proportion to its own gradient, and one whose
# gradient is zero in exact arithmetic, such as a key projection's bias,
# moves by +-lr on its rounding's sign; tests/test_torch_run.py reads 3.1e-3
# and 3.8e-3 against the JAX package; a skipped update gives 1). The card's
# starting state, what a run whose optimizer step is skipped leaves, must be
# refused by each moment rule and by the change rule. Then MAE_PARITY_VAL
# validation episodes a set; mIoU / FB-IoU within MAE_METRIC_ATOL (pixels at
# a near tie of two logits can take either class), argmax over the pixels
# agreeing on more than MAE_ARGMAX_AGREE
MAE_PARITY_STEPS, MAE_PARITY_VAL = 2, 8
MAE_LOSS_RTOL = 1e-4
MAE_MOMENT_REL_L2 = 1e-3
MAE_CHANGE_REL_L2 = 1e-2
MAE_METRIC_ATOL = 2e-3
MAE_ARGMAX_AGREE = 0.999
# phase 17's bf16 rate on in-memory batches (with masks), for phase 20
FLAGSHIP_RATE = {}


def mae_config(paths: dict, steps: int = MAE_STEPS, val: int = MAE_VAL,
               dtype: str = None) -> dict:
    """mae.yaml as the port's reader gives it, with the synthetic root's
    annotation and cache paths, one epoch, ``steps`` training steps and
    ``val`` episodes a validation set (``dtype`` replaces the model's)."""
    from labelanything_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(MAE_YAML)
    p = cfg["parameters"]
    for name, d in p["dataset"]["datasets"].items():
        d["instances_path"] = [paths["instances_path"]]
        d["emb_dir"] = [paths["emb_dir"]]
        if name.startswith("val_"):
            d["val_num_samples"] = [val]
    p["train_params"]["max_epochs"] = [1]
    p["dataloader"]["num_steps"] = [steps]
    if dtype is not None:
        p["model"]["dtype"] = [dtype]
    return cfg


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def first_moments(run) -> dict:
    """AdamW's first moment of each trained parameter, in float64 on the
    host."""
    state = run.state.optimizer.state
    return {n: state[p]["exp_avg"].detach().cpu().double()
            for n, p in run.state.model.named_parameters() if p in state}


def recorded_steps(run) -> tuple:
    """(the loss of each of ``run``'s train steps from now on, as tensors
    on its device; the AdamW first moments after the first of them)."""
    losses, first, step = [], {}, run.train_step

    def recorded(*args, **kw):
        state, aux = step(*args, **kw)
        losses.append(aux["loss"].detach())
        if not first:
            first.update(first_moments(run))
        return state, aux

    run.train_step = recorded
    return losses, first


def exact_zero_gradient(model) -> set:
    """The parameters whose gradient is zero in exact arithmetic, so that
    theirs is rounding alone: each attention's key bias (a softmax over the
    keys is invariant to it) and the class MLP's output bias (added alike
    to every class's logits, under the loss's softmax over the classes)."""
    last = model.mask_decoder.class_mlp.layers[-1].bias
    return {n for n, p in model.named_parameters()
            if n.endswith("k_proj.bias") or p is last}


def moment_verdict(moments: dict, ref: dict, zero: set) -> tuple:
    """Phase 5's rule at MAE_MOMENT_REL_L2 on each parameter's first moment
    against the reference's; a parameter of ``zero`` is held instead to
    under GRAD_FLOOR of the whole on both sides: (refusals, the three worst
    shares of their bound with their names)."""
    refused, shares = [], []
    whole = sum(float(r.norm() ** 2) for r in ref.values()) ** 0.5
    for name, r in ref.items():
        if name in zero:
            d = max(float(moments[name].norm()), float(r.norm()))
            allowed = GRAD_FLOOR * whole
        else:
            d = float((moments[name] - r).norm())
            allowed = MAE_MOMENT_REL_L2 * max(float(r.norm()),
                                              GRAD_FLOOR * whole)
        if d > allowed:
            refused.append(f"first moment of {name} {d:.3e} > {allowed:.3e}")
        shares.append((d / allowed, name))
    return refused, sorted(shares, reverse=True)[:3]


def whole_rel_l2(got: dict, ref: dict, base: dict = None) -> float:
    """|got - ref|_2 / |ref - base|_2 over all of the tensors as one vector
    (``base`` zero when not given)."""
    diff = sum(float((got[k] - ref[k]).norm() ** 2) for k in ref)
    size = sum(float((ref[k] - (0 if base is None else base[k])).norm() ** 2)
               for k in ref)
    return (diff / max(size, 1e-60)) ** 0.5


def mae_parity(paths: dict) -> None:
    """The fp32 run on the card (K7 forced, as phase 17 forces it) against
    the same run on the CPU."""
    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.train.substitutor import divide_query_examples
    from labelanything_tpu_torch.utils.config import expand_experiment

    flat = expand_experiment(mae_config(paths, MAE_PARITY_STEPS,
                                        MAE_PARITY_VAL, "float32"))[0]
    flat["train_params"].pop("scheduler")
    lr = flat["train_params"]["initial_lr"]
    t0 = time.perf_counter()
    gpu = Run().init(flat, f"{MAE_DIR}/fp32_card", device="cuda")
    cpu = Run().init(flat, f"{MAE_DIR}/fp32_cpu", device="cpu")
    cpu.state.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.state.model.state_dict().items()})
    host = lambda run: {k: v.detach().cpu().double()
                        for k, v in run.state.model.named_parameters()}
    start = host(cpu)
    (l_gpu, first_gpu), (l_cpu, first_cpu) = (recorded_steps(gpu),
                                              recorded_steps(cpu))
    fa.reset_launches()
    with fp32_twoway_kernel():
        gpu.train_epoch(0)
    forced = dict(fa.LAUNCHES)
    cpu.train_epoch(0)
    l_gpu, l_cpu = [float(x) for x in l_gpu], [float(x) for x in l_cpu]
    ref, ref_m, m_gpu = host(cpu), first_moments(cpu), first_moments(gpu)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    zero = exact_zero_gradient(cpu.state.model)
    refused, worst = moment_verdict(first_gpu, first_cpu, zero)
    rel_m = whole_rel_l2(m_gpu, ref_m)
    rel_c = whole_rel_l2(host(gpu), ref, start)
    # the control: the starting state, as a run without updates leaves it
    zeros = lambda moments: {k: torch.zeros_like(v)
                             for k, v in moments.items()}
    control = (len(moment_verdict(zeros(first_cpu), first_cpu, zero)[0]),
               whole_rel_l2(zeros(ref_m), ref_m),
               whole_rel_l2(start, ref, start))
    print(f"mae fp32 parity: {MAE_PARITY_STEPS} steps at a constant lr "
          f"{lr}, card (K7 forced, {forced.get('fused_twoway', 0)} "
          f"launches) vs CPU: losses " + ", ".join(
              f"{a:.6f} / {b:.6f}" for a, b in zip(l_gpu, l_cpu))
          + f" (relative {loss_rel:.2e}); the first step's first moments: "
          f"{len(refused)} refused by phase 5's rule at "
          f"{MAE_MOMENT_REL_L2} ({len(zero)} whose "
          f"gradient is zero in exact arithmetic held under its floor; "
          f"worst " + ", ".join(
              f"{name} {share:.3f}" for share, name in worst)
          + " of their bound); after the run the first moments' "
          f"relative L2 {rel_m:.3e} (allowed {GRAD_REL_L2}), the change's "
          f"{rel_c:.3e} (allowed {MAE_CHANGE_REL_L2}); control (the starting "
          f"state, no update): {control[0]} of {len(first_cpu)} first "
          f"moments refused, relative L2 {control[1]:.3f} and "
          f"{control[2]:.3f}")
    check(forced.get("fused_twoway", 0) > 0,
          f"mae fp32 parity: K7 was not launched ({nonzero(forced)})")
    check(len(l_gpu) == len(l_cpu) == MAE_PARITY_STEPS,
          f"mae fp32 parity: steps {len(l_gpu)} / {len(l_cpu)}")
    check(sorted(ref_m) == sorted(m_gpu)
          and sorted(first_cpu) == sorted(first_gpu),
          "mae fp32 parity: the runs trained other parameters")
    check(loss_rel <= MAE_LOSS_RTOL,
          f"mae fp32 parity: losses {l_gpu} / {l_cpu}")
    check(not refused, "mae fp32 parity: " + "; ".join(refused[:5]))
    check(rel_m <= GRAD_REL_L2 and rel_c <= MAE_CHANGE_REL_L2,
          f"mae fp32 parity: first moments {rel_m:.3e}, change {rel_c:.3e}")
    check(control[0] > 0 and control[1] > GRAD_REL_L2
          and control[2] > MAE_CHANGE_REL_L2,
          f"mae fp32 parity: the control passed ({control})")
    with fp32_twoway_kernel():
        v_gpu = gpu.validate(0)
    v_cpu = cpu.validate(0)
    for key in v_cpu:
        check(abs(v_gpu[key] - v_cpu[key]) <= MAE_METRIC_ATOL,
              f"mae fp32 parity: {key} card {v_gpu[key]:.5f} cpu "
              f"{v_cpu[key]:.5f}")
    same = total = 0
    for name, loader in gpu.val_loaders.items():
        for (batch, _), _ in loader:
            preds = []
            for run in (gpu, cpu):
                device_batch, _ = run._device_batch(
                    batch, example_rows=slice(1, None))
                inputs, gt = divide_query_examples(device_batch)
                with torch.no_grad(), (fp32_twoway_kernel()
                                       if run is gpu else
                                       contextlib.nullcontext()):
                    run.state.model.eval()
                    logits = run.state.model(inputs)[ResultDict.LOGITS]
                preds.append(logits.argmax(1).cpu())
            valid = torch.as_tensor(batch[BatchKeys.GROUND_TRUTHS][:, 0]
                                    != IGNORE_INDEX)
            same += int((preds[0] == preds[1])[valid].sum())
            total += int(valid.sum())
    agree = same / max(total, 1)
    check(agree > MAE_ARGMAX_AGREE,
          f"mae fp32 parity: argmax agreement {agree:.6f}")
    gpu.close()
    cpu.close()
    print(f"mae fp32 parity: validation "
          + ", ".join(f"{k} {v_gpu[k]:.5f} / {v_cpu[k]:.5f}" for k in v_cpu)
          + f"; argmax agreement {agree:.6f} over {total} pixels; "
          f"{time.perf_counter() - t0:.1f} s")


def phase_mae_run() -> dict:
    """Phase 20: train mae.yaml's bf16 model through the port's CLI on a
    synthetic COCO root, resume, time it, hold an fp32 run against the
    CPU."""
    import shutil

    from labelanything_tpu_torch import cli
    from labelanything_tpu_torch.data.synthetic_coco import write_synthetic_coco
    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.experiment import run as run_mod
    from labelanything_tpu_torch.train.checkpoint import STATE_FILE
    from labelanything_tpu_torch.train.substitutor import Substitutor
    from labelanything_tpu_torch.utils import yaml_subset
    from labelanything_tpu_torch.utils.config import expand_experiment

    t0 = time.perf_counter()
    shutil.rmtree(MAE_DIR, ignore_errors=True)
    paths = write_synthetic_coco(f"{MAE_DIR}/coco", seed=SEED,
                                 num_images=MAE_IMAGES)
    t_root = time.perf_counter() - t0
    cfg = mae_config(paths)
    params_path, run_dir = f"{MAE_DIR}/mae.yaml", f"{MAE_DIR}/run"
    with open(params_path, "w") as f:
        f.write(yaml_subset.dumps(cfg))

    # what the steps launch: per train step its tuple and K7's launches, per
    # launch its instances and cluster, per TwoWayTransformer call its
    # tokens and whether K7's rule took it
    steps, launched, calls = [], [], []
    capacity = ft.cluster_capacity(torch.device("cuda"))
    packed, rule, make_step = (ft.fused_twoway_packed, ft.fused_twoway_ok,
                               run_mod.make_train_step)

    def counted_packed(keys, queries, *args, **kw):
        g, s, _ = keys.shape
        launched.append((g, queries.shape[1],
                         ft.twoway_cluster(g, s, capacity)
                         if keys.dtype == torch.bfloat16 else 1))
        return packed(keys, queries, *args, **kw)

    def seen_rule(device, dtype, tokens, *args):
        ok = rule(device, dtype, tokens, *args)
        calls.append((tokens, ok))
        return ok

    def counted_make(**kw):
        step = make_step(**kw)

        def counted(state, batch, gt, *args, **k):
            n0, c0 = len(launched), len(calls)
            # the step's own time, its device work included
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch, gt, *args, **k)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            b, m, c = batch[BatchKeys.FLAG_EXAMPLES].shape
            steps.append(dict(tuple=(b, c - 1, m // max(c - 1, 1)), ms=ms,
                              launches=launched[n0:], calls=calls[c0:]))
            return out
        return counted

    # the batches' times in the loop: Run.batch_times of the epoch
    epochs, train_epoch = [], run_mod.Run.train_epoch

    def kept_times(self, epoch):
        out = train_epoch(self, epoch)
        epochs.append(list(self.batch_times))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with mock.patch.object(ft, "fused_twoway_packed", counted_packed), \
            mock.patch.object(ft, "fused_twoway_ok", seen_rule), \
            mock.patch.object(run_mod, "make_train_step", counted_make), \
            mock.patch.object(run_mod.Run, "train_epoch", kept_times):
        t1 = time.perf_counter()
        rc = cli.main(["run", "--parameters", params_path, "--out-dir",
                       run_dir])
        t_cli = time.perf_counter() - t1
    path_launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"mae run: the CLI returned {rc}")

    lines = read_jsonl(f"{run_dir}/metrics.jsonl")
    losses = [r["train/loss"] for r in lines if "train/loss" in r]
    check(len(losses) > 0 and all(np.isfinite(losses)),
          f"mae run: train losses {losses}")
    summary = next(r for r in lines if "train/avg_loss" in r)
    vals = {k: v for r in lines for k, v in r.items()
            if k.startswith("validate/")}
    for name in ("val_coco20i_N1K1", "val_coco20i_N2K1"):
        check(f"validate/{name}/miou" in vals, f"mae run: no {name} line")
    for tag in ("latest", "best"):
        check(os.path.exists(f"{run_dir}/checkpoints/{tag}/{STATE_FILE}"),
              f"mae run: no checkpoints/{tag}")
    check(len(steps) == MAE_STEPS, f"mae run: {len(steps)} train steps")
    # every step launches K7 (the mask decoder's call always fits it), and
    # every call its rule refused has more tokens than the kernel takes
    for st in steps:
        check(len(st["launches"]) >= 1, f"mae run: a {st['tuple']} step took "
              f"the module path at every call: {st['calls']}")
        check(len(st["launches"]) == sum(ok for _, ok in st["calls"]),
              f"mae run: {st}")
        check(all(t > ft.KERNEL_MAX_TOKENS for t, ok in st["calls"]
                  if not ok), f"mae run: a call K7 could take went the "
              f"module path: {st['calls']}")
    by_tuple = {}
    for st in steps:
        by_tuple.setdefault(st["tuple"], []).append(st)
    for key in sorted(by_tuple):
        group = by_tuple[key]
        inst = sorted({(g, n) for st in group for g, n, _ in st["launches"]})
        clusters = sorted({cl for st in group for _, _, cl in st["launches"]})
        refused = sorted({t for st in group for t, ok in st["calls"]
                          if not ok})
        print(f"mae run: tuple (batch, ways, shots) {key}: {len(group)} "
              f"steps, K7 launches a step "
              f"{sorted({len(st['launches']) for st in group})}, "
              f"(instances, tokens) a launch {inst}, clusters of {clusters} "
              f"blocks; calls over K7's {ft.KERNEL_MAX_TOKENS} tokens "
              f"(module path): {refused or 'none'}")
    # where a batch's time in the loop goes, from the third batch on: its
    # train step (timed between two synchronizations of the card), the wait
    # on the loader, the rest of the loop (the device copies, the class
    # tables, the confusion folds, the substitutor)
    times = epochs[0]
    check(len(times) == MAE_STEPS, f"mae run: {len(times)} batches timed")
    span = range(2, MAE_STEPS - 1)
    batch_ms = sum(times[i + 1][0] - times[i][0] for i in span) * 1e3
    step_ms = sum(steps[i]["ms"] for i in span)
    wait_ms = sum(times[i][1] for i in span) * 1e3
    print(f"mae run: batches 3 to {MAE_STEPS - 1} in the loop "
          f"{batch_ms / len(span):.1f} ms a batch: the train step "
          f"{step_ms / len(span):.1f} ms ({step_ms / batch_ms:.3f}), the "
          f"loader wait {wait_ms / len(span):.1f} ms "
          f"({wait_ms / batch_ms:.3f}), the rest of the loop "
          f"{(batch_ms - step_ms - wait_ms) / len(span):.1f} ms "
          f"({(batch_ms - step_ms - wait_ms) / batch_ms:.3f}); the step by "
          f"tuple (ms): " + ", ".join(
              f"{key} {np.median([st['ms'] for st in by_tuple[key]]):.1f}"
              for key in sorted(by_tuple)))
    all_calls = [ok for st in steps for _, ok in st["calls"]]
    print(f"mae run: {sum(all_calls)} of {len(all_calls)} TwoWayTransformer "
          f"calls of the train steps took K7; the rest had more than "
          f"{ft.KERNEL_MAX_TOKENS} prompt tokens (points and boxes padded to "
          f"the collate's bucket of 8)")

    # a second Run resumes at epoch 1 from exactly what was saved
    flat = expand_experiment({"parameters": cfg["parameters"]})[0]
    run2 = Run().init(flat, run_dir=run_dir, device="cuda")
    check(run2.start_epoch == 1, f"mae resume: epoch {run2.start_epoch}")
    saved = torch.load(f"{run_dir}/checkpoints/latest/{STATE_FILE}",
                       map_location="cuda", weights_only=True)
    for name, value in run2.state.model.state_dict().items():
        check(torch.equal(value, saved["model"][name]),
              f"mae resume: {name} differs from the checkpoint")
    moments = run2.state.optimizer.state_dict()["state"]
    for idx, entry in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(moments[idx][key], entry[key]),
                  f"mae resume: AdamW {key} of parameter {idx}")
    check(run2.state.step == saved["step"] == len(steps),
          f"mae resume: step {run2.state.step}")

    # the device's busy share over MAE_PROFILE_STEPS steps of the run
    batches = []
    for (batch, gts), _ in run2.train_loader:
        batches.append(run2._device_batch(batch)[0])
        if len(batches) == MAE_PROFILE_STEPS:
            break
    run2.close()
    step = run_mod.make_train_step(with_confmat=True)

    def body():
        t = time.perf_counter()
        for device_batch in batches:
            sub = Substitutor(num_points=1, substitute=False,
                              generator=run2.generator)
            sub.reset(device_batch)
            step(run2.state, *next(sub), run2.generator, 1.0)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    prof, wall = time_kernels.profile_pass(body)
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.key
               and not e.key.startswith("Optimizer.")]
    busy = sum(t for t, _, _ in kernels)
    print(f"mae run profile: {MAE_PROFILE_STEPS} steps of the run's batches, "
          f"{wall * 1e3 / MAE_PROFILE_STEPS:.1f} ms a step under the "
          f"profiler, kernel time {busy / MAE_PROFILE_STEPS:.1f} ms a step, "
          f"device busy {busy / (wall * 1e3):.3f} of the window")
    for t, n, key in sorted(kernels, reverse=True)[:10]:
        print(f"mae run profile:   {t / MAE_PROFILE_STEPS:8.3f} ms a step, "
              f"{n:5d} launches  {key[:90]}")
    rate = summary["train/avg_episodes_per_s"]
    print(f"mae run: synthetic root {t_root:.1f} s ({MAE_IMAGES} images, "
          f"768 x 30 x 30 caches); CLI run {t_cli:.1f} s: {MAE_STEPS} steps, "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, epoch "
          f"{summary['train/avg_epoch_time']:.2f} s, {rate:.2f} "
          f"episodes/s from the third step on, loader wait "
          f"{summary['train/avg_loader_wait_share']:.3f} of the epoch; "
          f"validation " + ", ".join(f"{k.split('/', 1)[1]} {v:.4f}"
                                     for k, v in sorted(vals.items())
                                     if not k.endswith("bmiou"))
          + f"; peak memory {peak / 2**30:.2f} GiB; launches "
          f"{nonzero(path_launches)}")
    print(f"mae run: phase 17 on in-memory batches (8 episodes of 5-way "
          f"1-shot, bf16, with masks) {FLAGSHIP_RATE.get('masks', float('nan')):.1f}"
          f" episodes/s, this run through the engine {rate:.2f}")
    mae_parity(paths)
    print(f"mae run: phase 20 took {time.perf_counter() - t0:.1f} s")
    return path_launches


# phase 21: the fold x rerun protocol of the validation file on phase 20's
# run, cut to EVAL_RERUNS of its 5 reruns and EVAL_VAL of its 1000
# episodes a set; the card against the CPU on EVAL_PARITY_VAL episodes of
# N1K1 and N2K1, fold 0, 1 rerun, within MAE_METRIC_ATOL
EVAL_YAML = "parameters/validation/COCO/mae.yaml"
EVAL_DIR = "build/eval_run"
# (1 rerun: each fold's sets, keys and episodes kept, phase 21 halved to
# keep the script inside its time limit; the 5-shot sets, which wait on
# the thread loader, at EVAL_VAL_5SHOT episodes for the same reason)
EVAL_RERUNS, EVAL_VAL, EVAL_PARITY_VAL = 1, 64, 16
EVAL_VAL_5SHOT = 16
EVAL_VAL_BY_SET = {"val_coco20i_N1K5": EVAL_VAL_5SHOT,
                   "val_coco20i_N2K5": EVAL_VAL_5SHOT}
# the validation file's model block is not the training file's: a
# checkpoint of mae.yaml loads once the block matches it
EVAL_MODEL = {"example_class_attention": [True]}
# phase 22: a synthetic VOC root of VOC_IMAGES images, mae.yaml of
# PASCAL-5i cut to one epoch of VOC_STEPS steps and VOC_VAL episodes a set
PASCAL_YAML = "parameters/trainval/pascal/mae.yaml"
VOC_DIR = "build/voc_run"
VOC_IMAGES, VOC_STEPS, VOC_VAL = 200, 32, 64
# phase 23: the test protocol at TEST_BATCH queries a call; the card
# against the CPU on TEST_PARITY_QUERIES query images
TEST_DIR = "build/test_run"
TEST_BATCH, TEST_PARITY_QUERIES = 8, 16
# one chunk's logits against the fp32 CPU's, each pixel's mean over the
# classes taken out (``centered_distance``): the fp32 card within
# TEST_FP32_REL_L2; the bf16 card within TEST_BF16_RATIO x the distance of
# the same model in bf16 on the CPU (with random weights the classes part
# by about 0.5 % of the logits' level, so bf16 arithmetic moves the
# classes' part by about a third, and the argmax by chance)
TEST_FP32_REL_L2, TEST_BF16_RATIO = 1e-3, 2.0
TEST_LOGIT_QUERIES = 4


def mae_paths() -> dict:
    """Phase 20's synthetic COCO root."""
    return {"instances_path": f"{MAE_DIR}/coco/instances.json",
            "emb_dir": f"{MAE_DIR}/coco/embeddings"}


def protocol_config(yaml_path: str, paths: dict, val: int, sets=None,
                    model: dict = None, val_by_set: dict = None) -> dict:
    """The parameter file ``yaml_path`` as the port's reader gives it, its
    sets' data paths replaced by ``paths`` and ``val`` episodes a
    validation set (``val_by_set`` names the sets that take another
    count); ``sets`` keeps those alone (in every grid), ``model`` updates
    the model block."""
    from labelanything_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(yaml_path)
    p = cfg["parameters"]
    datasets = p["dataset"]["datasets"]
    for name in list(datasets):
        if sets is not None and name not in sets:
            del datasets[name]
            for grid in cfg.get("other_grids", []):
                grid.get("dataset", {}).get("datasets", {}).pop(name, None)
            continue
        datasets[name].update({k: [v] for k, v in paths.items()})
        if name.startswith("val_"):
            datasets[name]["val_num_samples"] = [
                (val_by_set or {}).get(name, val)]
    if model:
        p["model"].update(model)
    return cfg


def write_params(cfg: dict, path: str) -> str:
    from labelanything_tpu_torch.utils import yaml_subset

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(yaml_subset.dumps(cfg))
    return path


def cli_main(argv: list, log: str) -> int:
    """``labelanything_tpu_torch.cli.main(argv)``, what it prints written
    to ``log``."""
    from labelanything_tpu_torch import cli

    os.makedirs(os.path.dirname(log), exist_ok=True)
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        return cli.main(argv)


def close_enough(got: dict, ref: dict, what: str) -> None:
    """Every number of ``ref`` in ``got`` within MAE_METRIC_ATOL."""
    check(sorted(got) == sorted(ref), f"{what}: keys {sorted(got)} / "
          f"{sorted(ref)}")
    for key, value in ref.items():
        check(np.isfinite(got[key]) and abs(got[key] - value)
              <= MAE_METRIC_ATOL, f"{what}: {key} card {got[key]:.5f} cpu "
              f"{value:.5f}")


def confusions_agree(card: tuple, cpu: tuple, what: str,
                     agree: float = MAE_ARGMAX_AGREE) -> float:
    """The card's and the CPU's confusion matrices (classes, then
    background / foreground) of one pass: the same ground-truth count in
    every row, exactly, and more than ``agree`` of the pixels in the same
    cell (a pixel whose prediction moved leaves one cell and enters
    another: half the L1 distance counts the moved pixels). Returns the
    share in the same cell, the least of the two matrices'."""
    shares = []
    for a, b in zip(card, cpu):
        check(a.shape == b.shape and np.array_equal(a.sum(1), b.sum(1)),
              f"{what}: confusion rows (ground truth) {a.sum(1)} / "
              f"{b.sum(1)}")
        shares.append(1 - np.abs(a - b).sum() / 2 / max(int(b.sum()), 1))
    check(min(shares) > agree, f"{what}: confusion cells agree on "
          f"{shares} of the pixels, at most {agree}")
    return min(shares)


def forward_timer(spans: list):
    """A ``build_on_device`` whose model's forward is timed between two
    synchronizations: each call appends its seconds to ``spans``."""
    from labelanything_tpu_torch.experiment import run as run_mod

    build = run_mod.build_on_device

    def timed(*args, **kw):
        model = build(*args, **kw)
        start = {}

        def pre(mod, inputs):
            torch.cuda.synchronize()
            start["t"] = time.perf_counter()

        def post(mod, inputs, output):
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - start["t"])

        model.register_forward_pre_hook(pre)
        model.register_forward_hook(post)
        return model

    return timed


def validation_recorder(records: list, spans: list = None):
    """A ``Run._validate_one`` that appends, per pass, the set's name, its
    ``Run.val_batch_times`` and ``Run.confusions``, and the forward times
    that ``spans`` gained meanwhile."""
    from labelanything_tpu_torch.experiment import run as run_mod

    validate_one = run_mod.Run._validate_one

    def kept(self, loader, name, epoch=None):
        n = len(spans) if spans is not None else 0
        out = validate_one(self, loader, name, epoch)
        records.append(dict(name=name, times=self.val_batch_times[name],
                            confusion=self.confusions[name],
                            forwards=spans[n:] if spans is not None else []))
        return out

    return kept


def site_counter(counts: dict):
    """A ``build_on_device`` that tags the model's two TwoWayTransformer
    call sites: forward hooks add each call's K7 launches to
    ``counts[site]``."""
    from labelanything_tpu_torch.experiment import run as run_mod

    build = run_mod.build_on_device

    def tagged(*args, **kw):
        model = build(*args, **kw)
        for site in ("prompt_encoder", "mask_decoder"):
            module = getattr(model, site).transformer
            before = {}

            def pre(mod, inputs, before=before):
                before["n"] = fa.LAUNCHES.get("fused_twoway", 0)

            def post(mod, inputs, output, before=before, site=site):
                counts[site] = (counts.get(site, 0)
                                + fa.LAUNCHES.get("fused_twoway", 0)
                                - before["n"])

            module.register_forward_pre_hook(pre)
            module.register_forward_hook(post)
        return model

    return tagged


def threads_back(before: int) -> int:
    """The thread count once the loaders' finished producers exit (at most
    a second)."""
    import threading

    for _ in range(100):
        if threading.active_count() <= before:
            break
        time.sleep(0.01)
    return threading.active_count()


def phase_eval() -> dict:
    """Phase 21: ``validate --checkpoint`` on phase 20's run: the
    validation file's 4 folds through the CLI, ``--folds`` / ``--compare``,
    bf16 on mae.yaml's own sets with K7 at both call sites, the card
    against the CPU."""
    import shutil
    import threading

    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.experiment import evaluate as ev
    from labelanything_tpu_torch.experiment import run as run_mod
    from labelanything_tpu_torch.utils.config import expand_experiment

    t0 = time.perf_counter()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    paths, ckpt = mae_paths(), f"{MAE_DIR}/run/checkpoints"

    # the file as it stands refuses the checkpoint by name
    as_is = expand_experiment(protocol_config(EVAL_YAML, paths, EVAL_VAL))[0]
    run = Run().init(as_is, run_dir=f"{EVAL_DIR}/as_is", device="cuda")
    loaded = ev._load_model_params(ckpt, run)
    refusal = None
    try:
        ev._check_tree_match(run.state.model, loaded)
    except ValueError as exc:
        refusal = str(exc)
    finally:
        run.close()
    check(refusal is not None and "class_example_attention" in refusal,
          f"eval: the validation file's own model block took the checkpoint "
          f"({refusal})")
    print(f"eval: {EVAL_YAML} as it stands refuses mae.yaml's checkpoint: "
          f"{refusal[:160]}...")

    params = write_params(protocol_config(EVAL_YAML, paths, EVAL_VAL,
                                          model=EVAL_MODEL,
                                          val_by_set=EVAL_VAL_BY_SET),
                          f"{EVAL_DIR}/validation.yaml")
    fold_s, validate = [], run_mod.Run.validate

    def timed(self, epoch):
        t = time.perf_counter()
        out = validate(self, epoch)
        fold_s.append(time.perf_counter() - t)
        return out

    # each pass's batch times and forwards, recorded inside the CLI's Runs
    records, spans = [], []
    threads = threading.active_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with mock.patch.object(run_mod.Run, "validate", timed), \
            mock.patch.object(run_mod, "build_on_device",
                              forward_timer(spans)), \
            mock.patch.object(run_mod.Run, "_validate_one",
                              validation_recorder(records, spans)):
        t1 = time.perf_counter()
        rc = cli_main(["validate", "--parameters", params, "--checkpoint",
                       ckpt, "--reruns", str(EVAL_RERUNS), "--out-dir",
                       f"{EVAL_DIR}/all"], f"{EVAL_DIR}/all.out")
        t_cli = time.perf_counter() - t1
    fp32_launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"eval: the CLI returned {rc}")
    after = threads_back(threads)
    check(after <= threads, f"eval: {after} threads after the folds, "
          f"{threads} before")
    with open(f"{EVAL_DIR}/all/results.json") as f:
        results = json.load(f)
    sets = list(expand_experiment(protocol_config(
        EVAL_YAML, paths, EVAL_VAL))[0]["dataset"]["datasets"])
    for fold in range(4):
        for name in sets:
            for metric in ("miou", "fbiou", "bmiou"):
                key = f"fold{fold}/{name}_{metric}"
                check(key in results and np.isfinite(results[key]),
                      f"eval: {key} {results.get(key)}")
    check(np.isfinite(results["mean/miou"])
          and np.isfinite(results["mean/fbiou"]),
          f"eval: means {results.get('mean/miou')} "
          f"{results.get('mean/fbiou')}")
    counts = [EVAL_VAL_BY_SET.get(name, EVAL_VAL) for name in sets]
    episodes = 4 * EVAL_RERUNS * sum(counts)
    print(f"eval: validate --checkpoint, 4 folds x {len(sets)} sets x "
          f"{EVAL_RERUNS} reruns x {'/'.join(map(str, counts))} episodes "
          f"(fp32, module path: "
          f"launches {nonzero(fp32_launches)}): CLI {t_cli:.1f} s, the "
          f"folds' validation " + ", ".join(f"{t:.1f}" for t in fold_s)
          + f" s, {episodes / sum(fold_s):.2f} episodes/s, peak memory "
          f"{peak / 2**30:.2f} GiB, threads {threads} before / {after} "
          f"after")
    print("eval: fold table\n" + ev.fold_table(results, list(range(4))))
    # where a validation batch's time goes in that run, set by set over its
    # folds and reruns: the loader wait, the forward, the rest (device
    # copies, class tables, confusion folds)
    check(len(records) == 4 * len(sets) * EVAL_RERUNS,
          f"eval: {len(records)} validation passes recorded")
    for name in sets:
        mine = [r for r in records if r["name"] == name]
        for r in mine:
            check(len(r["forwards"]) == len(r["times"]),
                  f"eval: {name}: {len(r['forwards'])} forwards in "
                  f"{len(r['times'])} batches")
        batches = sum(len(r["times"]) for r in mine)
        episodes = sum(t[3] for r in mine for t in r["times"])
        wait = sum(t[1] for r in mine for t in r["times"])
        total = sum(t[2] for r in mine for t in r["times"])
        forward = sum(sum(r["forwards"]) for r in mine)
        print(f"eval: {name} (fp32, the CLI run), {batches} batches of "
              f"{episodes // batches} episodes: {episodes / total:.2f} "
              f"episodes/s in the loop, a batch {total * 1e3 / batches:.1f} "
              f"ms: loader wait {wait / total:.3f}, forward "
              f"{forward / total:.3f}, the rest "
              f"{1 - (wait + forward) / total:.3f}")

    # --folds and --compare, on fold 0's N1K1 and N2K1 at
    # EVAL_PARITY_VAL episodes (the file the card against the CPU reads)
    pair = ("val_coco20i_N1K1", "val_coco20i_N2K1")
    small = write_params(protocol_config(
        EVAL_YAML, paths, EVAL_PARITY_VAL, sets=pair, model=EVAL_MODEL),
        f"{EVAL_DIR}/validation_parity.yaml")
    ref = {"mean/miou": 0.5, f"fold0/{sets[0]}_miou": 0.25,
           "fold1/miou": 0.0}
    ref_path = f"{EVAL_DIR}/reference.json"
    with open(ref_path, "w") as f:
        json.dump(ref, f)
    rc = cli_main(["validate", "--parameters", small, "--checkpoint", ckpt,
                   "--folds", "0", "--reruns", "1", "--compare", ref_path,
                   "--out-dir", f"{EVAL_DIR}/fold0"], f"{EVAL_DIR}/fold0.out")
    check(rc == 0, f"eval --compare: the CLI returned {rc}")
    with open(f"{EVAL_DIR}/fold0/results.json") as f:
        one = json.load(f)
    deltas = one["deltas_vs_reference"]
    check(sorted(deltas) == sorted(["mean/miou", f"fold0/{sets[0]}_miou"])
          and not any(k.startswith("fold1/") for k in one),
          f"eval --compare: keys {sorted(deltas)}")
    for key, value in deltas.items():
        check(value == one[key] - ref[key],
              f"eval --compare: {key} delta {value} != {one[key]} - "
              f"{ref[key]}")
    check(one["max_abs_delta"] == max(abs(v) for v in deltas.values()),
          f"eval --compare: max_abs_delta {one['max_abs_delta']}")
    print(f"eval: --folds 0 --compare: deltas " + ", ".join(
        f"{k} {v:+.5f}" for k, v in sorted(deltas.items()))
          + f" (= result - reference), max {one['max_abs_delta']:.5f}")

    # bf16 on mae.yaml's own sets: K7 at both call sites
    bf16 = write_params(protocol_config(MAE_YAML, paths, EVAL_VAL),
                        f"{EVAL_DIR}/mae_bf16.yaml")
    sites: dict = {}
    fa.reset_launches()
    with mock.patch.object(run_mod, "build_on_device", site_counter(sites)):
        t1 = time.perf_counter()
        res_bf16 = ev.evaluate_checkpoint(bf16, ckpt,
                                          out_dir=f"{EVAL_DIR}/bf16",
                                          folds=[0], reruns=1)
        t_bf16 = time.perf_counter() - t1
    path_launches = dict(fa.LAUNCHES)
    check(all(sites.get(s, 0) > 0 for s in ("prompt_encoder",
                                            "mask_decoder")),
          f"eval bf16: K7 launches by call site {sites}")
    check(sum(sites.values()) == path_launches.get("fused_twoway", 0),
          f"eval bf16: sites {sites}, launches {nonzero(path_launches)}")
    check(all(np.isfinite(v) for v in res_bf16.values()),
          f"eval bf16: {res_bf16}")
    print(f"eval: bf16, mae.yaml's N1K1 / N2K1 (fold 0, 1 rerun, {EVAL_VAL} "
          f"episodes a set): {t_bf16:.1f} s, "
          f"{2 * EVAL_VAL / t_bf16:.2f} episodes/s with the Run's set-up; "
          f"K7 launches by call site {sites}; " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(res_bf16.items())))

    # the busy share of a validation pass
    flat = expand_experiment(protocol_config(EVAL_YAML, paths, EVAL_VAL,
                                             model=EVAL_MODEL,
                                             val_by_set=EVAL_VAL_BY_SET))[0]
    run = Run().init(flat, run_dir=f"{EVAL_DIR}/timed", device="cuda")
    run.state.model.load_state_dict(ev._load_model_params(ckpt, run))
    heavy = "val_coco20i_N2K5"

    def body():
        t = time.perf_counter()
        run._validate_one(run.val_loaders[heavy], heavy)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    prof, wall = time_kernels.profile_pass(body)
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.key]
    busy = sum(t for t, _, _ in kernels)
    run.close()
    print(f"eval profile: {heavy}, {EVAL_VAL_BY_SET[heavy]} episodes, "
          f"{wall:.2f} s under "
          f"the profiler, kernel time {busy:.1f} ms, device busy "
          f"{busy / (wall * 1e3):.3f} of the window")
    for t, n, key in sorted(kernels, reverse=True)[:6]:
        print(f"eval profile:   {t:8.2f} ms, {n:5d} launches  {key[:90]}")

    # the card against the CPU: fold 0, N1K1 and N2K1, 1 rerun
    passes = {"cuda": [], "cpu": []}
    with mock.patch.object(run_mod.Run, "_validate_one",
                           validation_recorder(passes["cuda"])):
        card = ev.evaluate_checkpoint(small, ckpt, out_dir=f"{EVAL_DIR}/card",
                                      folds=[0], reruns=1, device="cuda")
    t1 = time.perf_counter()
    with mock.patch.object(run_mod.Run, "_validate_one",
                           validation_recorder(passes["cpu"])):
        cpu = ev.evaluate_checkpoint(small, ckpt, out_dir=f"{EVAL_DIR}/cpu",
                                     folds=[0], reruns=1, device="cpu")
    close_enough(card, cpu, "eval parity")
    check([r["name"] for r in passes["cuda"]] == list(pair)
          == [r["name"] for r in passes["cpu"]],
          f"eval parity: passes {passes}")
    cells = {a["name"]: confusions_agree(a["confusion"], b["confusion"],
                                         f"eval parity {a['name']}")
             for a, b in zip(passes["cuda"], passes["cpu"])}
    # the CLI's --compare run read the same file on the card
    again = max(abs(one[k] - v) for k, v in card.items())
    check(again <= MAE_METRIC_ATOL, f"eval: the CLI's fold 0 and "
          f"evaluate_checkpoint's differ by {again}")
    print(f"eval parity (fp32, fold 0, {EVAL_PARITY_VAL} episodes of "
          f"{', '.join(pair)}, CPU {time.perf_counter() - t1:.1f} s): "
          + ", ".join(f"{k} {card[k]:.5f} / {cpu[k]:.5f}"
                      for k in sorted(cpu))
          + f"; the CLI's --compare run on the card within {again:.2e}; "
          f"confusion cells agreeing " + ", ".join(
              f"{k} {v:.6f} of {int(passes['cpu'][i]['confusion'][0].sum())}"
              f" pixels" for i, (k, v) in enumerate(cells.items())))
    print(f"eval: phase 21 took {time.perf_counter() - t0:.1f} s")
    return path_launches


def pascal_config(voc: dict, steps: int = VOC_STEPS, val: int = VOC_VAL,
                  dtype: str = None) -> dict:
    cfg = protocol_config(PASCAL_YAML, voc, val)
    p = cfg["parameters"]
    p["train_params"]["max_epochs"] = [1]
    p["dataloader"]["num_steps"] = [steps]
    if dtype is not None:
        p["model"]["dtype"] = [dtype]
    return cfg


def phase_pascal() -> dict:
    """Phase 22: PASCAL-5i: a synthetic VOC root, ``cli run`` on
    trainval/pascal/mae.yaml (trains and validates), ``validate
    --checkpoint`` on its run, the card against the CPU."""
    import glob
    import shutil

    from labelanything_tpu_torch.data import native, png
    from labelanything_tpu_torch.data.synthetic_voc import write_synthetic_voc
    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.utils.config import expand_experiment

    t0 = time.perf_counter()
    shutil.rmtree(VOC_DIR, ignore_errors=True)
    voc = write_synthetic_voc(f"{VOC_DIR}/voc", seed=SEED,
                              num_images=VOC_IMAGES)
    t_root = time.perf_counter() - t0
    native.load_library()       # its first-use build stays out of the times
    masks = sorted(glob.glob(f"{VOC_DIR}/voc/SegmentationClass/*.png"))
    t = time.perf_counter()
    segs = [png.read_png(m) for m in masks]
    decode_ms = {"no filter (as written: libpng's choice for a palette)":
                 (time.perf_counter() - t) * 1e3 / len(masks)}
    for rows, label in (("adaptive", "adaptive"), (4, "Paeth")):
        blobs = [png.encode_png(s, png.voc_palette(), filters=rows)
                 for s in segs[:40]]
        t = time.perf_counter()
        for b, seg in zip(blobs, segs):
            check(np.array_equal(png.decode_png(b)[0], seg),
                  f"pascal: a mask under filter {rows} read back otherwise")
        decode_ms[label] = (time.perf_counter() - t) * 1e3 / len(blobs)
    print(f"pascal: synthetic VOC root {t_root:.1f} s ({VOC_IMAGES} masks of "
          f"VOC's sizes, 768 x 30 x 30 caches); ms a mask decode "
          f"(data/png.py, on the card machine's host): " + ", ".join(
              f"{k} {v:.2f}" for k, v in decode_ms.items()))

    cfg = pascal_config(voc)
    params, run_dir = (write_params(cfg, f"{VOC_DIR}/pascal.yaml"),
                       f"{VOC_DIR}/run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t1 = time.perf_counter()
    rc = cli_main(["run", "--parameters", params, "--out-dir", run_dir],
                  f"{VOC_DIR}/run.out")
    t_cli = time.perf_counter() - t1
    path_launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"pascal run: the CLI returned {rc}")
    lines = read_jsonl(f"{run_dir}/metrics.jsonl")
    losses = [r["train/loss"] for r in lines if "train/loss" in r]
    check(len(losses) > 0 and all(np.isfinite(losses)),
          f"pascal run: train losses {losses}")
    summary = next(r for r in lines if "train/avg_loss" in r)
    vals = {k.split("/", 1)[1]: v for r in lines for k, v in r.items()
            if k.startswith("validate/")}
    for name in ("val_pascal5i_N1K1", "val_pascal5i_N2K1"):
        check(f"{name}/miou" in vals and np.isfinite(vals[f"{name}/miou"]),
              f"pascal run: no {name} line")
    rc = cli_main(["validate", "--parameters", params, "--checkpoint",
                   f"{run_dir}/checkpoints", "--out-dir", f"{VOC_DIR}/eval"],
                  f"{VOC_DIR}/eval.out")
    check(rc == 0, f"pascal validate: the CLI returned {rc}")
    with open(f"{VOC_DIR}/eval/results.json") as f:
        results = json.load(f)
    # the run validated its last weights with the same seeds
    worst = 0.0
    for key, value in vals.items():
        name, metric = key.split("/")
        got = results[f"fold0/{name}_{metric}"]
        worst = max(worst, abs(got - value))
        check(abs(got - value) <= MAE_METRIC_ATOL,
              f"pascal validate: {key} {got} against the run's {value}")
    print(f"pascal run: CLI {t_cli:.1f} s, {VOC_STEPS} steps (fp32, module "
          f"path: launches {nonzero(path_launches)}), loss {losses[0]:.5f} "
          f"-> {losses[-1]:.5f}, {summary['train/avg_episodes_per_s']:.2f} "
          f"episodes/s from the third step on, loader wait "
          f"{summary['train/avg_loader_wait_share']:.3f} of the epoch, peak "
          f"memory {peak / 2**30:.2f} GiB; validation " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(vals.items())
              if not k.endswith("bmiou"))
          + f"; validate --checkpoint gives the run's own numbers "
          f"(largest difference {worst:.2e})")

    # the card against the CPU: the first steps' losses, then validation
    flat = expand_experiment(pascal_config(voc, MAE_PARITY_STEPS,
                                           MAE_PARITY_VAL))[0]
    flat["train_params"].pop("scheduler")
    gpu = Run().init(flat, f"{VOC_DIR}/fp32_card", device="cuda")
    cpu = Run().init(flat, f"{VOC_DIR}/fp32_cpu", device="cpu")
    cpu.state.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.state.model.state_dict().items()})
    (l_gpu, _), (l_cpu, _) = recorded_steps(gpu), recorded_steps(cpu)
    t1 = time.perf_counter()
    gpu.train_epoch(0)
    cpu.train_epoch(0)
    l_gpu, l_cpu = [float(x) for x in l_gpu], [float(x) for x in l_cpu]
    check(len(l_gpu) == len(l_cpu) == MAE_PARITY_STEPS,
          f"pascal parity: steps {len(l_gpu)} / {len(l_cpu)}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    check(loss_rel <= MAE_LOSS_RTOL,
          f"pascal parity: losses {l_gpu} / {l_cpu}")
    v_gpu, v_cpu = gpu.validate(0), cpu.validate(0)
    cells = {name: confusions_agree(gpu.confusions[name],
                                    cpu.confusions[name],
                                    f"pascal parity {name}")
             for name in cpu.val_loaders}
    close_enough(v_gpu, v_cpu, "pascal parity")
    gpu.close()
    cpu.close()
    print(f"pascal parity (fp32, {MAE_PARITY_STEPS} steps at a constant lr, "
          f"{MAE_PARITY_VAL} validation episodes a set; "
          f"{time.perf_counter() - t1:.1f} s): losses " + ", ".join(
              f"{a:.6f} / {b:.6f}" for a, b in zip(l_gpu, l_cpu))
          + f" (relative {loss_rel:.2e}); " + ", ".join(
              f"{k} {v_gpu[k]:.5f} / {v_cpu[k]:.5f}" for k in sorted(v_cpu))
          + "; confusion cells agreeing " + ", ".join(
              f"{k} {v:.6f}" for k, v in cells.items()))
    print(f"pascal: phase 22 took {time.perf_counter() - t0:.1f} s")
    return path_launches


def test_protocol_config(paths: dict, dtype: str = None) -> dict:
    """A ``test_coco`` set on ``paths`` under the model block of
    mae.yaml (its frame and resize), its support prompts drawn from
    ``SEED`` (a test set takes no ``common`` parameters)."""
    from labelanything_tpu_torch.utils.config import load_yaml

    p = load_yaml(MAE_YAML)["parameters"]
    model = dict(p["model"])
    if dtype is not None:
        model["dtype"] = [dtype]
    common = p["dataset"]["common"]
    frame = {"image_size": common["image_size"],
             "custom_preprocess": common["custom_preprocess"]}
    return {"parameters": {
        "seed": [SEED], "model": model, "train_params": {},
        "dataset": {"datasets": {"test_coco": {
            **{k: [v] for k, v in paths.items()}, **frame, "seed": [SEED]}},
            "common": dict(frame)},
        "dataloader": {}}}


def test_logits(run, set_params: dict, queries: int) -> tuple:
    """(fp32 logits on the host, ground truth) of the test set's first
    ``queries`` images, as ``Run._test_one`` makes them: class embeddings
    of the support batch, then ``predict`` on one chunk."""
    from labelanything_tpu_torch.data.test import CocoLVISTestDataset
    from labelanything_tpu_torch.experiment.run import drop_absent_modalities

    dataset = CocoLVISTestDataset(**set_params)
    to_device = lambda v: torch.from_numpy(np.asarray(v)).to(run.device)
    model = run.state.model.eval()
    with torch.no_grad():
        support = drop_absent_modalities(dataset.extract_prompts())
        embs = model.generate_class_embeddings(
            {k: to_device(v) for k, v in support.items()})
        batch, gt = dataset.collate_fn([dataset[i] for i in range(queries)])
        logits = model.predict({k: to_device(v) for k, v in batch.items()},
                               embs)
    return logits.float().cpu(), torch.from_numpy(gt)


def centered_distance(got: torch.Tensor, ref: torch.Tensor,
                      valid: torch.Tensor) -> float:
    """Relative L2 distance of two (B, C, H, W) logits over the valid
    pixels, each pixel's mean over the classes taken out first: what
    separates the classes, not their common level."""
    def centered(x):
        x = x.permute(0, 2, 3, 1)[valid].double()
        return x - x.mean(dim=1, keepdim=True)

    c_got, c_ref = centered(got), centered(ref)
    return float((c_got - c_ref).norm() / c_ref.norm())


def phase_test_protocol() -> dict:
    """Phase 23: ``cli test`` (bf16, mae.yaml's model block, COCO's 80
    categories of phase 20's root, TEST_BATCH queries a call), then the
    card against the CPU in fp32 on TEST_PARITY_QUERIES queries."""
    import shutil

    from labelanything_tpu_torch.data.test import CocoLVISTestDataset
    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.experiment import run as run_mod
    from labelanything_tpu_torch.utils.config import expand_experiment

    t0 = time.perf_counter()
    shutil.rmtree(TEST_DIR, ignore_errors=True)
    paths = mae_paths()
    params = write_params(test_protocol_config(paths),
                          f"{TEST_DIR}/test.yaml")
    seen, calls, rule = {}, [], ft.fused_twoway_ok
    test_one = run_mod.Run._test_one

    def kept(self, dataset, name, batch_size):
        out = test_one(self, dataset, name, batch_size)
        seen.update(times=dict(self.test_times[name]), metrics=out,
                    support=len(dataset._extract_support_examples(
                        dataset.cat2img, dataset.img2cat)),
                    classes=dataset.num_classes)
        return out

    def seen_rule(device, dtype, tokens, *args):
        ok = rule(device, dtype, tokens, *args)
        calls.append((tokens, ok))
        return ok

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with mock.patch.object(run_mod.Run, "_test_one", kept), \
            mock.patch.object(ft, "fused_twoway_ok", seen_rule):
        t1 = time.perf_counter()
        rc = cli_main(["test", "--parameters", params, "--out-dir",
                       f"{TEST_DIR}/run", "--batch-size", str(TEST_BATCH)],
                      f"{TEST_DIR}/run.out")
        t_cli = time.perf_counter() - t1
    path_launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"test: the CLI returned {rc}")
    metrics, times = seen["metrics"], seen["times"]
    check(sorted(metrics) == ["fbiou", "miou"]
          and all(np.isfinite(v) for v in metrics.values()),
          f"test: metrics {metrics}")
    check(all(t > ft.KERNEL_MAX_TOKENS for t, ok in calls if not ok),
          f"test: a call K7 could take went the module path: {calls}")
    check(sum(ok for _, ok in calls) == path_launches.get("fused_twoway", 0),
          f"test: K7 calls {calls}, launches {nonzero(path_launches)}")
    tokens = sorted({t for t, _ in calls})
    print(f"test: cli test (bf16, {seen['classes']} classes with the "
          f"background, {seen['support']} support images, "
          f"{times['queries']} queries in chunks of {TEST_BATCH}): CLI "
          f"{t_cli:.1f} s, support set {times['support_s']:.2f} s, queries "
          f"{times['queries'] / times['queries_s']:.2f} images/s, peak "
          f"memory {peak / 2**30:.2f} GiB; miou {metrics['miou']:.5f}, "
          f"fbiou {metrics['fbiou']:.5f}; TwoWayTransformer calls "
          f"{len(calls)}, K7 took {sum(ok for _, ok in calls)} (tokens "
          f"{tokens[:3]} ... {tokens[-3:]}; over {ft.KERNEL_MAX_TOKENS} "
          f"the module path); launches {nonzero(path_launches)}")

    # the card against the CPU: fp32, the first queries' images alone
    with open(paths["instances_path"]) as f:
        inst = json.load(f)
    keep = {im["id"] for im in inst["images"][:TEST_PARITY_QUERIES]}
    anns = [a for a in inst["annotations"] if a["image_id"] in keep]
    cats = {a["category_id"] for a in anns}
    small = {"images": [im for im in inst["images"] if im["id"] in keep],
             "annotations": anns,
             "categories": [c for c in inst["categories"] if c["id"] in cats]}
    small_path = f"{TEST_DIR}/instances_{TEST_PARITY_QUERIES}.json"
    with open(small_path, "w") as f:
        json.dump(small, f)
    cfg = test_protocol_config(dict(paths, instances_path=small_path),
                               dtype="float32")
    flat = expand_experiment(cfg)[0]
    set_params = flat["dataset"]["datasets"]["test_coco"]
    gpu = Run().init(flat, f"{TEST_DIR}/card", device="cuda")
    cpu = Run().init(flat, f"{TEST_DIR}/cpu", device="cpu")
    state = {k: v.cpu() for k, v in gpu.state.model.state_dict().items()}
    cpu.state.model.load_state_dict(state)
    m_gpu = gpu._test_one(CocoLVISTestDataset(**set_params), "test_coco",
                          TEST_BATCH)
    t1 = time.perf_counter()
    dataset = CocoLVISTestDataset(**set_params)
    check(len(dataset) == TEST_PARITY_QUERIES,
          f"test parity: {len(dataset)} queries")
    m_cpu = cpu._test_one(dataset, "test_coco", TEST_BATCH)
    t_cpu = time.perf_counter() - t1
    close_enough(m_gpu, m_cpu, "test parity")
    ref = cpu.confusions["test_coco"]
    cell = confusions_agree(gpu.confusions["test_coco"], ref, "test parity")
    # the card in bf16 (the CLI run's dtype) against the fp32 CPU: the
    # matrices, then one chunk's logits; a control with the categories'
    # columns rolled by one must be refused
    half = Run().init(expand_experiment(test_protocol_config(
        dict(paths, instances_path=small_path)))[0], f"{TEST_DIR}/bf16",
        device="cuda")
    half.state.model.load_state_dict(state)
    m_half = half._test_one(CocoLVISTestDataset(**set_params), "test_coco",
                            TEST_BATCH)
    check(all(np.isfinite(v) for v in m_half.values()),
          f"test bf16: {m_half}")
    cells_half = [1 - np.abs(a - b).sum() / 2 / max(int(b.sum()), 1)
                  for a, b in zip(half.confusions["test_coco"], ref)]
    half_cpu = Run().init(expand_experiment(test_protocol_config(
        dict(paths, instances_path=small_path)))[0], f"{TEST_DIR}/bf16_cpu",
        device="cpu")
    half_cpu.state.model.load_state_dict(state)
    l_cpu, gt = test_logits(cpu, set_params, TEST_LOGIT_QUERIES)
    l_half = test_logits(half, set_params, TEST_LOGIT_QUERIES)[0]
    valid = gt != IGNORE_INDEX
    rolled = torch.cat([l_half[:, :1], l_half[:, 1:].roll(1, dims=1)], 1)
    dist = {"fp32 card": centered_distance(test_logits(
                gpu, set_params, TEST_LOGIT_QUERIES)[0], l_cpu, valid),
            "bf16 card": centered_distance(l_half, l_cpu, valid),
            "control": centered_distance(rolled, l_cpu, valid),
            "bf16 CPU": centered_distance(test_logits(
                half_cpu, set_params, TEST_LOGIT_QUERIES)[0], l_cpu, valid),
            "fp32 CPU rounded to bf16": centered_distance(
                l_cpu.bfloat16().float(), l_cpu, valid)}
    bound = TEST_BF16_RATIO * dist["bf16 CPU"]
    for run in (gpu, cpu, half, half_cpu):
        run.close()
    flat_ref = l_cpu.permute(0, 2, 3, 1)[valid]
    top2 = flat_ref.topk(2, dim=1).values
    margin = top2[:, 0] - top2[:, 1]
    spread = float((flat_ref - flat_ref.mean(1, keepdim=True)).std())
    same = l_half.permute(0, 2, 3, 1)[valid].argmax(1) == flat_ref.argmax(1)
    by_margin = {t: (float(same[margin > t * spread].float().mean()),
                     float((margin > t * spread).float().mean()))
                 for t in (0.0, 0.1, 0.3, 1.0)}
    print(f"test parity (fp32, {TEST_PARITY_QUERIES} queries, "
          f"{dataset.num_classes} classes with the background; CPU "
          f"{t_cpu:.1f} s): " + ", ".join(
              f"{k} {m_gpu[k]:.5f} / {m_cpu[k]:.5f}" for k in sorted(m_cpu))
          + f"; confusion cells agreeing {cell:.6f} of "
          f"{int(ref[0].sum())} pixels; bf16 card " + ", ".join(
              f"{k} {m_half[k]:.5f}" for k in sorted(m_half))
          + f", its cells agreeing with the fp32 CPU's {cells_half[0]:.6f} "
          f"(classes), {cells_half[1]:.6f} (bg / fg)")
    print(f"test logits against the fp32 CPU's ({TEST_LOGIT_QUERIES} "
          f"queries, {int(valid.sum())} pixels, |max| "
          f"{float(flat_ref.abs().max()):.3g}, class spread {spread:.3g}): "
          f"centered relative L2 " + ", ".join(
              f"{k} {v:.3e}" for k, v in dist.items())
          + "; the bf16 argmax agreeing where the fp32 margin passes t x "
          "spread: " + ", ".join(f"t {t}: {a:.6f} of {n:.3f} of the pixels"
                                 for t, (a, n) in by_margin.items()))
    check(dist["fp32 card"] <= TEST_FP32_REL_L2 and dist["bf16 card"]
          <= bound, f"test logits: centered relative L2 {dist}")
    check(dist["control"] > bound,
          f"test logits: the rolled control passed: {dist}")
    print(f"test: phase 23 took {time.perf_counter() - t0:.1f} s")
    return path_launches


# phase 24: the committed image fixtures and PIL's record of them
FIXTURES = "tests/fixtures/images"
DECODE_THREADS, DECODE_REPEATS = 16, 320
# phase 25: a synthetic COCO image root of EMBED_IMAGES images (every
# fourth a PNG: 180 JPEGs), embedded in batches of 8; enough images
# that every COCO-20i class of phase 26 has examples
IMAGES_DIR = "build/images_run"
EMBED_IMAGES, EMBED_BATCH, EMBED_SIZE = 240, 8, 1024
# the bf16 cache against the fp32 CPU encoder, relative L2 (bf16 keeps 8
# bits of mantissa through 12 blocks)
EMBED_BF16_REL_L2 = 5e-2
# phase 26: COCO_vit.yaml for VIT_STEPS steps; the first step's loss of a
# one-episode batch, card against CPU (fp32), relative
VIT_YAML = "parameters/trainval/other/COCO_vit.yaml"
VIT_STEPS, VIT_VAL, VIT_LOSS_RTOL = 4, 4, 2e-3
ENCODER_BWD = ("relpos_global_bwd", "relpos_window_bwd")
# phase 27: the four cross-domain test files, lam_b in the model block
CROSS_SETS = {"test_kvasir": "kvasir", "test_weedmap": "weedmap",
              "test_brain": "brain", "test_dram": "dram"}
CROSS_MODEL = {"name": ["lam_b"], "image_embed_dim": [256]}


def array_digest(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def phase_image_decode() -> None:
    """Phase 24: the fixtures through the port's decoders against PIL's
    record; the C JPEG decoder's time."""
    from concurrent.futures import ThreadPoolExecutor

    from labelanything_tpu_torch.data import image_io, jpeg, native

    t0 = time.perf_counter()
    with open(f"{FIXTURES}/pil_decoded.json") as f:
        record = json.load(f)
    native.load_library()
    t_build = time.perf_counter() - t0
    plain_s = {}
    for name, rec in sorted(record.items()):
        with open(f"{FIXTURES}/{name}", "rb") as f:
            data = f.read()
        image = image_io.decode_image(data)
        check(image.mode == rec["mode"] and list(image.array.shape)
              == rec["shape"] and array_digest(image.array) == rec["sha256"],
              f"decode {name}: {image.mode} {image.array.shape} differs "
              f"from PIL's record")
        check(array_digest(image_io.convert(image, target="RGB"))
              == rec["rgb_sha256"], f"decode {name}: RGB differs from PIL's")
        if name.endswith(".jpg"):
            t = time.perf_counter()
            plain = jpeg.decode_jpeg_plain(data)
            plain_s[name] = time.perf_counter() - t
            check(np.array_equal(plain, image.array),
                  f"decode {name}: the numpy twin differs from the C decoder")
    name = "coco_640x480_420.jpg"
    with open(f"{FIXTURES}/{name}", "rb") as f:
        data = f.read()
    times = []
    for _ in range(53):     # 3 warm-up calls, then 50 timed on the host
        t = time.perf_counter()
        jpeg.decode_jpeg(data)
        times.append((time.perf_counter() - t) * 1e3)
    one = statistics.median(times[3:])
    with ThreadPoolExecutor(DECODE_THREADS) as pool:
        list(pool.map(jpeg.decode_jpeg, [data] * DECODE_THREADS))
        t = time.perf_counter()
        list(pool.map(jpeg.decode_jpeg, [data] * DECODE_REPEATS))
        rate = DECODE_REPEATS / (time.perf_counter() - t)
    print(f"decode: {len(record)} fixtures equal PIL's record ("
          f"{sum(n.endswith('.jpg') for n in record)} JPEGs also the numpy "
          f"twin's bytes); the host library (decoder, unfilter, "
          f"resample) built and loaded in {t_build:.2f} s; "
          f"{name} (640 x 480, 4:2:0) {one:.3f} ms on one thread, "
          f"{rate:.1f} images/s on {DECODE_THREADS} threads "
          f"({os.cpu_count()} cores); the twin {plain_s[name]:.2f} s "
          f"(the 427 x 640 one {plain_s['coco_portrait_427x640_420.jpg']:.2f}"
          f" s)")
    host_loops(data)
    print(f"decode: phase 24 took {time.perf_counter() - t0:.1f} s")


def host_loops(jpeg_data: bytes) -> None:
    """Phase 24's second half: the pass from files' other two host loops,
    C against the numpy twins on the same input, on one thread: the row
    filters of the fixture's 480 x 640 pixels written as an RGB PNG
    (adaptive filters, as the synthetic roots write them) and the resize
    to 1024 px; then ``preprocess.load_one`` (decode, resize, pad) of that
    JPEG and that PNG on one thread and on DECODE_THREADS threads, with
    the host library and with the twins swapped in, which hold the GIL."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from labelanything_tpu_torch import preprocess
    from labelanything_tpu_torch.data import jpeg, png, transforms

    def host_ms(fn, n):
        times = []
        for _ in range(n + 1):          # a warm-up call, then n timed
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times[1:])

    rgb = jpeg.decode_jpeg(jpeg_data)
    h, w = rgb.shape[:2]
    blob = png.encode_png(rgb)
    raw = np.frombuffer(zlib.decompress(b"".join(
        payload for kind, payload in png._chunks(blob) if kind == b"IDAT")),
        np.uint8).reshape(h, 1 + w * 3)
    check(np.array_equal(png.unfilter(raw, h, w, 3),
                         png.unfilter_plain(raw, h, w, 3)),
          "host loops: the PNG unfilter differs from its twin")
    size = transforms.get_preprocess_shape(h, w, EMBED_SIZE)
    check(np.array_equal(transforms.resize_uint8(rgb, size),
                         transforms.resize_uint8_plain(rgb, size)),
          "host loops: the resize differs from its twin")
    ms = {"unfilter": (host_ms(lambda: png.unfilter(raw, h, w, 3), 20),
                       host_ms(lambda: png.unfilter_plain(raw, h, w, 3), 3)),
          "resize": (host_ms(lambda: transforms.resize_uint8(rgb, size), 20),
                     host_ms(lambda: transforms.resize_uint8_plain(rgb, size),
                             3))}
    os.makedirs(IMAGES_DIR, exist_ok=True)
    files = {"JPEG": f"{FIXTURES}/coco_640x480_420.jpg",
             "PNG": f"{IMAGES_DIR}/host_loops.png"}
    with open(files["PNG"], "wb") as f:
        f.write(blob)
    twins = ((png, "unfilter", png.unfilter_plain),
             (transforms, "resize_uint8", transforms.resize_uint8_plain),
             (preprocess, "resize_uint8", transforms.resize_uint8_plain))
    rates = {}
    for route in ("C", "numpy"):
        with contextlib.ExitStack() as stack:
            if route == "numpy":
                for mod, attr, twin in twins:
                    stack.enter_context(mock.patch.object(mod, attr, twin))
            for kind, path in files.items():
                one = host_ms(lambda: preprocess.load_one(
                    (1, path), EMBED_SIZE, True), 10 if route == "C" else 3)
                n = 4 * DECODE_THREADS if route == "C" else DECODE_THREADS
                with ThreadPoolExecutor(DECODE_THREADS) as pool:
                    t = time.perf_counter()
                    list(pool.map(lambda i: preprocess.load_one(
                        (i, path), EMBED_SIZE, True), range(n)))
                    rate = n / (time.perf_counter() - t)
                rates[route, kind] = (one, rate)
    print(f"host loops (one thread, C / numpy twin): {w} x {h} RGB PNG's "
          f"row filters {ms['unfilter'][0]:.3f} / {ms['unfilter'][1]:.2f} ms, "
          f"the resize to {size[1]} x {size[0]} {ms['resize'][0]:.3f} / "
          f"{ms['resize'][1]:.2f} ms; load_one to {EMBED_SIZE} px, ms on one "
          f"thread and images/s on {DECODE_THREADS} threads: " + ", ".join(
              f"{kind} {route} {one:.2f} ms, {rate:.1f}/s"
              for (route, kind), (one, rate) in rates.items()))


def image_root_paths() -> dict:
    return {"instances_path": f"{IMAGES_DIR}/coco/instances.json",
            "img_dir": f"{IMAGES_DIR}/coco/images"}


def kernel_counts(prof, names: dict) -> dict:
    """Launches in a profiler pass of the kernels whose names hold each
    value of ``names``, by key."""
    records = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {key: sum(e.count for e in records if sub in e.key)
            for key, sub in names.items()}


def phase_generate_embeddings() -> dict:
    """Phase 25: ``cli generate_embeddings`` and ``cli generate_gt`` on a
    synthetic COCO image root."""
    import shutil

    from labelanything_tpu_torch.data.image_io import read_rgb
    from labelanything_tpu_torch.preprocess import load_one, normalize
    from labelanything_tpu_torch.utils.safetensors import load_file

    t0 = time.perf_counter()
    shutil.rmtree(IMAGES_DIR, ignore_errors=True)
    paths = write_image_root()
    check(paths == image_root_paths(), f"image root {paths}")
    with open(paths["instances_path"]) as f:
        images = json.load(f)["images"]
    jpegs = sum(im["file_name"].endswith(".jpg") for im in images)
    out = f"{IMAGES_DIR}/embeddings"
    argv = ["generate_embeddings", "--directory", paths["img_dir"],
            "--instances_path", paths["instances_path"], "--batch_size",
            str(EMBED_BATCH), "--num_workers", "16", "--image_size",
            str(EMBED_SIZE)]
    names = {"relpos_global": fa.global_kernel(torch.bfloat16, (64, 64)),
             "relpos_window": "window_tc_kernel"}

    def body():
        fa.reset_launches()
        return cli_main(argv + ["--outfolder", out + "_profiled"],
                        f"{IMAGES_DIR}/profiled.out")

    prof, rc = time_kernels.profile_pass(body)
    launches = dict(fa.LAUNCHES)
    seen = kernel_counts(prof, names)
    check(rc == 0, f"generate_embeddings returned {rc}")
    batches = -(-EMBED_IMAGES // EMBED_BATCH)
    expect_launches(launches, {k: v * batches for k, v in
                               ENCODER_LAUNCHES.items()}, "generate_embeddings")
    check(seen == {k: launches[k] for k in names},
          f"generate_embeddings: the profiler saw {seen}, the counters "
          f"{nonzero(launches)}")
    t1 = time.perf_counter()
    rc = cli_main(argv + ["--outfolder", out], f"{IMAGES_DIR}/timed.out")
    t_cli = time.perf_counter() - t1
    check(rc == 0, f"generate_embeddings returned {rc}")
    with open(f"{IMAGES_DIR}/timed.out") as f:
        rate = json.loads(f.read().strip().splitlines()[-1])[
            "images_per_second"]
    caches = sorted(os.listdir(out))
    check(len(caches) == EMBED_IMAGES, f"{len(caches)} caches")

    # one image's cache against the CPU port on the same decoded frame
    first = images[0]
    item = (first["id"], read_rgb(f"{paths['img_dir']}/{first['file_name']}"))
    _, frame, hw = load_one(item, EMBED_SIZE, True)
    vit = build_vit_b(project_last_hidden=True, image_size=EMBED_SIZE).eval()
    init_weights(vit, SEED)
    with torch.no_grad():
        want = vit(normalize(torch.from_numpy(frame)[None],
                             torch.tensor([hw])))[0]
    got = load_file(f"{out}/{first['id']:012d}.safetensors")["embedding"]
    got = got.permute(1, 2, 0)
    rel = float((got - want).norm() / want.norm())
    check(rel <= EMBED_BF16_REL_L2 and torch.isfinite(got).all(),
          f"generate_embeddings: image {first['id']}'s cache against the "
          f"CPU: relative L2 {rel}")

    rc = cli_main(["generate_gt", "--dataset_name", "coco", "--anns_path",
                   paths["instances_path"], "--outfolder", out],
                  f"{IMAGES_DIR}/gt.out")
    check(rc == 0, f"generate_gt returned {rc}")
    with_gt = 0
    for im in images:
        f = load_file(f"{out}/{im['id']:012d}.safetensors")
        check(sorted(f) == ["coco_gt", "embedding"] and tuple(
            f["coco_gt"].shape) == (im["height"], im["width"]),
            f"generate_gt: image {im['id']}: {sorted(f)}")
        with_gt += int(f["coco_gt"].max() > 0)
    check(with_gt == len(images), f"generate_gt: {with_gt} of "
          f"{len(images)} maps hold a category")
    print(f"generate_embeddings: {EMBED_IMAGES} images ({jpegs} JPEGs, "
          f"{EMBED_IMAGES - jpegs} PNGs) decoded, resized and embedded by "
          f"vit_b bf16 in batches of {EMBED_BATCH}: {rate:.2f} images/s "
          f"(the CLI call {t_cli:.1f} s, the model's build included); "
          f"launches {nonzero(launches)}, the profiler's {seen}; image "
          f"{first['id']}'s cache against the CPU's fp32 encoder: relative "
          f"L2 {rel:.3e}; generate_gt wrote {with_gt} maps")
    print(f"generate_embeddings: phase 25 took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def vit_config(paths: dict, steps: int = VIT_STEPS, val: int = VIT_VAL,
               tuples=None) -> dict:
    """COCO_vit.yaml as the port's reader gives it, on the image root:
    ``checkpoint`` and ``use_sam_checkpoint`` out of the model block, one
    epoch of ``steps`` steps, the N1K1 validation set alone at ``val``
    episodes (``val`` 0: no validation set), 16 loader threads."""
    from labelanything_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(VIT_YAML)
    cfg.pop("other_grids")
    p = cfg["parameters"]
    for key in ("checkpoint", "use_sam_checkpoint"):
        p["model"].pop(key)
    datasets = p["dataset"]["datasets"]
    for name in list(datasets):
        if name.startswith("val_") and (name != "val_coco20i_N1K1"
                                        or val == 0):
            del datasets[name]
            continue
        datasets[name].update({k: [v] for k, v in paths.items()})
        if name.startswith("val_"):
            datasets[name]["val_num_samples"] = [val]
    p["train_params"]["max_epochs"] = [1]
    p["logger"]["log_frequency"] = [1]
    p["dataloader"].update(num_steps=[steps], num_workers=[16])
    if tuples is not None:
        p["dataloader"]["possible_batch_example_nums"] = [tuples]
    return cfg


def phase_vit_run() -> dict:
    """Phase 26: COCO_vit.yaml's lam_b trained through ``cli run`` on the
    image root, the frozen encoder's kernels counted a step."""
    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.experiment import run as run_mod
    from labelanything_tpu_torch.utils.config import expand_experiment

    t0 = time.perf_counter()
    paths = image_root_paths()
    params = write_params(vit_config(paths), f"{IMAGES_DIR}/vit.yaml")
    steps, make_step = [], run_mod.make_train_step

    def counted_make(**kw):
        step = make_step(**kw)

        def counted(state, batch, gt, *args, **k):
            before = dict(fa.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch, gt, *args, **k)
            torch.cuda.synchronize()
            steps.append(dict(
                images=int(np.prod(batch[BatchKeys.IMAGES].shape[:2])),
                ms=(time.perf_counter() - t) * 1e3,
                launches={k: fa.LAUNCHES[k] - before[k] for k in before
                          if fa.LAUNCHES[k] != before[k]}))
            return out
        return counted

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(run_mod, "make_train_step", counted_make):
        t1 = time.perf_counter()
        rc = cli_main(["run", "--parameters", params, "--out-dir",
                       f"{IMAGES_DIR}/vit_run"], f"{IMAGES_DIR}/vit_run.out")
        t_cli = time.perf_counter() - t1
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(rc == 0, f"COCO_vit run: the CLI returned {rc}")
    lines = read_jsonl(f"{IMAGES_DIR}/vit_run/metrics.jsonl")
    losses = [r["train/loss"] for r in lines if "train/loss" in r]
    check(len(steps) == VIT_STEPS and len(losses) == VIT_STEPS
          and all(np.isfinite(losses)), f"COCO_vit run: {len(steps)} steps, "
          f"losses {losses}")
    for i, s in enumerate(steps):
        check(s["launches"].get("relpos_global", 0) == 4
              and s["launches"].get("relpos_window", 0) == 8
              and not any(s["launches"].get(k, 0) for k in ENCODER_BWD),
              f"COCO_vit run: step {i} launched {s['launches']}")
    vals = {k: v for r in lines for k, v in r.items()
            if k.startswith("validate/")}
    check(vals and all(np.isfinite(list(vals.values()))),
          f"COCO_vit run: validation {vals}")

    # the first step of a one-episode batch, card against CPU
    flat = expand_experiment(vit_config(paths, 1, 0, [[1, 1, 1]]))[0]
    flat["train_params"].pop("scheduler")
    gpu = Run().init(flat, f"{IMAGES_DIR}/vit_card", device="cuda")
    cpu = Run().init(flat, f"{IMAGES_DIR}/vit_cpu", device="cpu")
    cpu.state.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.state.model.state_dict().items()})
    (l_gpu, _), (l_cpu, _) = recorded_steps(gpu), recorded_steps(cpu)
    t2 = time.perf_counter()
    gpu.train_epoch(0)
    cpu.train_epoch(0)
    t_parity = time.perf_counter() - t2
    gpu.close()
    cpu.close()
    l_gpu, l_cpu = float(l_gpu[0]), float(l_cpu[0])
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    images = sum(s["images"] for s in steps)
    step_ms = [round(s["ms"], 1) for s in steps]
    print(f"COCO_vit run: lam_b fp32 at 1024 px, backbone frozen, "
          f"{VIT_STEPS} steps of " + ", ".join(
              str(s["images"]) for s in steps)
          + f" images: step ms {step_ms}, {images / (sum(step_ms) / 1e3):.2f}"
          f" images/s in the steps; the CLI call {t_cli:.1f} s; peak "
          f"{peak:.2f} GiB; launches {nonzero(launches)} (per step K1 4, "
          f"K2 8, no backward); losses " + ", ".join(
              f"{x:.5f}" for x in losses) + f"; validation " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(vals.items()))
          + f"; the first step's loss card {l_gpu:.6f} / CPU {l_cpu:.6f} "
          f"(relative {rel:.2e}, {t_parity:.1f} s)")
    check(rel <= VIT_LOSS_RTOL, f"COCO_vit parity: loss {l_gpu} / {l_cpu}")
    print(f"COCO_vit run: phase 26 took {time.perf_counter() - t0:.1f} s")
    return launches


def cross_config(name: str, set_params: dict) -> dict:
    """``parameters/test/<set>.yaml`` with ``lam_b`` in its model block and
    the synthetic root's paths in place of the file's (weedmap.yaml names a
    ``root``, which the WeedMap set does not take: ROADMAP C13)."""
    from labelanything_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(f"parameters/test/{CROSS_SETS[name]}.yaml")
    p = cfg["parameters"]
    p["model"].update(CROSS_MODEL)
    sets = p["dataset"]["datasets"]
    sets[name] = {"image_size": sets[name]["image_size"],
                  **{k: [v] for k, v in set_params.items()}}
    return cfg


def phase_crossdomain() -> dict:
    """Phase 27: ``cli test`` on the four cross-domain layouts."""
    from labelanything_tpu_torch.data.dataset import test_registry
    from labelanything_tpu_torch.data.synthetic_crossdomain import (
        write_crossdomain_roots)
    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.utils.config import expand_experiment

    t0 = time.perf_counter()
    roots = write_crossdomain_roots(
        f"{IMAGES_DIR}/crossdomain",
        jpegs=[f"{FIXTURES}/coco_640x480_420.jpg",
               f"{FIXTURES}/coco_portrait_427x640_420.jpg"],
        kvasir_pairs=[(f"{FIXTURES}/coco_640x480_420.jpg",
                       f"{FIXTURES}/mask_640x480.jpg"),
                      (f"{FIXTURES}/coco_portrait_427x640_420.jpg",
                       f"{FIXTURES}/mask_427x640.jpg")],
        brain_pairs=[(f"{FIXTURES}/{n}", f"{FIXTURES}/brain_mask_lzw.tif")
                     for n in ("brain_raw.tif", "brain_tiff_lzw.tif",
                               "brain_packbits.tif",
                               "brain_tiff_adobe_deflate_pred.tif")],
        seed=SEED)
    launches, report = {}, []
    for name in CROSS_SETS:
        params = write_params(cross_config(name, roots[name]),
                              f"{IMAGES_DIR}/{name}.yaml")
        fa.reset_launches()
        t1 = time.perf_counter()
        rc = cli_main(["test", "--parameters", params, "--out-dir",
                       f"{IMAGES_DIR}/{name}", "--batch-size", "8"],
                      f"{IMAGES_DIR}/{name}.out")
        dt = time.perf_counter() - t1
        check(rc == 0, f"{name}: cli test returned {rc}")
        got = dict(fa.LAUNCHES)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        lines = read_jsonl(f"{IMAGES_DIR}/{name}/metrics.jsonl")
        metrics = {k: v for r in lines for k, v in r.items()
                   if k.startswith("test/")}
        check(len(metrics) >= 2 and all(np.isfinite(list(metrics.values()))),
              f"{name}: metrics {metrics}")
        check(got.get("relpos_global", 0) >= 8
              and got.get("relpos_window", 0) >= 16,
              f"{name}: launches {nonzero(got)}")
        report.append(f"{name} {dt:.1f} s " + ", ".join(
            f"{k.split('/')[-1]} {v:.4f}" for k, v in sorted(metrics.items()))
            + f" (K1 {got['relpos_global']}, K2 {got['relpos_window']})")
    print("crossdomain: cli test, lam_b fp32 at 480 px: " + "; ".join(report))

    # Kvasir: the card against the CPU from the same weights
    flat = expand_experiment(cross_config("test_kvasir",
                                          roots["test_kvasir"]))[0]
    gpu = Run().init(flat, f"{IMAGES_DIR}/kvasir_card", device="cuda")
    cpu = Run().init(flat, f"{IMAGES_DIR}/kvasir_cpu", device="cpu")
    cpu.state.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.state.model.state_dict().items()})
    dataset = lambda: test_registry()["test_kvasir"](
        **flat["dataset"]["datasets"]["test_kvasir"])
    m_gpu = gpu._test_one(dataset(), "test_kvasir", 8)
    m_cpu = cpu._test_one(dataset(), "test_kvasir", 8)
    close_enough(m_gpu, m_cpu, "kvasir parity")
    cell = confusions_agree(gpu.confusions["test_kvasir"],
                            cpu.confusions["test_kvasir"], "kvasir parity")
    gpu.close()
    cpu.close()
    print(f"crossdomain: kvasir fp32 card / CPU: " + ", ".join(
        f"{k} {m_gpu[k]:.5f} / {m_cpu[k]:.5f}" for k in sorted(m_cpu))
        + f"; confusion cells agreeing {cell:.6f}")
    print(f"crossdomain: phase 27 took {time.perf_counter() - t0:.1f} s")
    return launches


# phase 28: the ResNet / VGG baselines through ``cli validate`` at the full
# width of their files (BAM, HDMNet: ResNet-50 at 473 px; PPNet, DENet:
# ResNet-50 at 417; PANet: VGG16 at 417), seeded weights, fp32 (the files
# set no dtype): (model, file, the sets kept, the root)
BASELINE_DIR = "build/baselines_run"
BASELINE_VAL = 16                 # episodes a set (the files': 1000)
BASELINE_VOC_IMAGES = 200
BASELINE_FILES = (
    ("bam", "parameters/validation/COCO/bam_1shot.yaml",
     ("val_coco20i_N1K1",), "coco"),
    ("hdmnet", "parameters/validation/COCO/hdmnet_N5-10-15-20.yaml",
     ("val_coco20i_N5K1",), "coco"),
    ("panet", "parameters/validation/COCO/panet.yaml",
     ("val_coco20i_N1K1", "val_coco20i_N2K1"), "coco"),
    # the Pascal files give no data_dir (ROADMAP C12): the VOC root's
    ("ppnet", "parameters/validation/Pascal/ppnet.yaml",
     ("val_pascal5i_N2K1",), "voc"),
    ("denet", "parameters/validation/Pascal/denet.yaml",
     ("val_pascal5i_N1K1", "val_pascal5i_N2K1"), "voc"),
)
BASELINE_ARGMAX_AGREE = 0.999
SWIN_VIT_DIR = "build/swin_vit_run"


def write_image_root() -> dict:
    """Phase 25's synthetic COCO image root (EMBED_IMAGES images: the
    committed COCO-sized JPEGs copied, every fourth an RGB PNG)."""
    from labelanything_tpu_torch.data.synthetic_coco import write_synthetic_coco

    return write_synthetic_coco(
        f"{IMAGES_DIR}/coco", seed=SEED, num_images=EMBED_IMAGES,
        image_sources=[f"{FIXTURES}/coco_640x480_420.jpg",
                       f"{FIXTURES}/coco_portrait_427x640_420.jpg"],
        embeddings=False)


def baseline_logits_agree(gpu: torch.Tensor, cpu: torch.Tensor,
                          what: str) -> tuple:
    """The card's fp32 logits against the CPU's: the same non-finite
    (unflagged) classes, the finite ones within rtol 1e-3 / atol 5e-4, the
    argmax on more than BASELINE_ARGMAX_AGREE of the pixels. Returns (max
    |card - cpu|, the logits' scale, the argmax agreement)."""
    g, c = gpu.float().cpu().numpy(), cpu.float().numpy()
    finite = np.isfinite(c)
    check(np.array_equal(np.isfinite(g), finite) and finite.any(),
          f"{what}: the non-finite logits differ")
    diff = float(np.abs(g[finite] - c[finite]).max())
    check(np.allclose(g[finite], c[finite], rtol=1e-3, atol=5e-4),
          f"{what}: logits card / cpu differ by up to {diff:.3g}")
    agree = float((g.argmax(1) == c.argmax(1)).mean())
    check(agree > BASELINE_ARGMAX_AGREE, f"{what}: argmax agrees on {agree}")
    return diff, float(np.abs(c[finite]).max()), agree


def baseline_file_pass(name: str, path: str, sets: tuple, paths: dict,
                       out_dir: str) -> dict:
    """``cli validate`` of one baseline file on the card (``sets`` kept,
    BASELINE_VAL episodes each, one rerun), its sets' rates, a profiler
    pass over its first set and one batch card against CPU, printed on one
    line; returns the CLI call's kernel launches."""
    import copy

    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.experiment import run as run_mod
    from labelanything_tpu_torch.train.substitutor import divide_query_examples
    from labelanything_tpu_torch.utils.config import expand_experiment

    passes = []
    validate_one = run_mod.Run._validate_one

    def timed(self, loader, set_name, epoch=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = validate_one(self, loader, set_name, epoch)
        passes.append((set_name, time.perf_counter() - t,
                       self.val_batch_times[set_name]))
        return out

    t1 = time.perf_counter()
    cfg = protocol_config(path, paths, BASELINE_VAL, sets=sets)
    params = write_params(cfg, f"{out_dir}/{name}.yaml")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with mock.patch.object(run_mod.Run, "_validate_one", timed):
        rc = cli_main(["validate", "--parameters", params, "--out-dir",
                       f"{out_dir}/{name}", "--reruns", "1"],
                      f"{out_dir}/{name}.out")
    t_cli = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"{name}: cli validate returned {rc}")
    launches = dict(fa.LAUNCHES)
    metrics = {k.split("/", 1)[1]: v
               for r in read_jsonl(f"{out_dir}/{name}/metrics.jsonl")
               for k, v in r.items() if k.startswith("validate/")}
    check(len(metrics) == 3 * len(sets)
          and all(np.isfinite(list(metrics.values()))),
          f"{name}: metrics {metrics}")
    check([p[0] for p in passes] == list(sets), f"{name}: sets {passes}")
    rates = []
    for set_name, dt, times in passes:
        episodes = sum(t[3] for t in times)
        check(episodes == BASELINE_VAL, f"{name} {set_name}: {episodes} "
              "episodes")
        # after the first batch (cuDNN's first calls, allocator growth)
        late = (episodes - times[0][3]) / (times[0][0] + dt - times[1][0])
        wait = sum(t[1] for t in times) / dt
        rates.append(f"{set_name} {episodes / dt:.2f} episodes/s "
                     f"({late:.2f} after the first batch), loader wait "
                     f"{wait:.3f} of the pass")

    # a profiler pass over the first set, then one batch card / CPU
    flat = expand_experiment(cfg)[0]
    run = Run().init(flat, f"{out_dir}/{name}_direct", device="cuda")
    loader = run.val_loaders[sets[0]]

    def body():
        t = time.perf_counter()
        run._validate_one(loader, sets[0])
        torch.cuda.synchronize()
        return time.perf_counter() - t

    prof, wall = time_kernels.profile_pass(body)
    busy = sum(e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.key)
    (batch, _), _ = next(iter(loader))
    device_batch, _ = run._device_batch(batch, example_rows=slice(1, None))
    inputs, _ = divide_query_examples(device_batch)
    model = run.state.model.eval()
    with torch.no_grad():
        gpu = model(inputs)[ResultDict.LOGITS]
        cpu_model = copy.deepcopy(model).cpu()
        t2 = time.perf_counter()
        cpu = cpu_model({k: v.cpu() for k, v in inputs.items()})[
            ResultDict.LOGITS]
        t_cpu = time.perf_counter() - t2
    diff, scale, agree = baseline_logits_agree(gpu, cpu, name)
    run.close()
    del run, model, cpu_model
    torch.cuda.empty_cache()
    print(f"baselines: {name} ({path.split('/', 2)[2]}, model "
          f"{flat['model']}): cli validate {t_cli:.1f} s, "
          + ", ".join(rates) + f", peak {peak / 2**30:.2f} GiB; "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())
                      if not k.endswith("bmiou"))
          + f"; {sets[0]} under the profiler {wall:.2f} s, kernel time "
          f"{busy:.1f} ms, device busy {busy / (wall * 1e3):.3f}; one "
          f"batch {tuple(gpu.shape)} card / CPU (CPU {t_cpu:.1f} s): "
          f"max |diff| {diff:.3g} at scale {scale:.3g}, argmax agreeing "
          f"{agree:.6f}; {time.perf_counter() - t1:.1f} s")
    return launches


def baseline_roots() -> dict:
    """Phase 25's COCO image root and phase 28's VOC root of
    BASELINE_VOC_IMAGES JPEGs, each written where it is missing."""
    from labelanything_tpu_torch.data.synthetic_voc import write_synthetic_voc

    coco = image_root_paths()
    if not os.path.exists(coco["instances_path"]):
        coco = write_image_root()
    voc_dir = f"{BASELINE_DIR}/voc"
    if not os.path.exists(voc_dir):
        write_synthetic_voc(
            voc_dir, seed=SEED, num_images=BASELINE_VOC_IMAGES,
            image_sources=[f"{FIXTURES}/coco_640x480_420.jpg",
                           f"{FIXTURES}/coco_portrait_427x640_420.jpg"],
            embeddings=False)
    return {"coco": coco, "voc": {"data_dir": voc_dir}}


def replay_golden(names) -> None:
    """The golden fixtures ``names`` replayed on the card, each against the
    original's outputs at its case's tolerances."""
    from tests.torch_golden_replay import replay_baseline

    for name in names:
        t1 = time.perf_counter()
        ours, ref = replay_baseline(name, "cuda")
        CASES[name].compare(ours, ref)
        print(f"golden {name}: fp32 on the card {time.perf_counter() - t1:.2f}"
              f" s, max |port - reference| " + ", ".join(
                  f"{k} {np.abs(ours[k] - ref[k]).max():.3g} (scale "
                  f"{np.abs(ref[k]).max():.3g})" for k in sorted(ref)))
    torch.cuda.empty_cache()


def phase_baselines() -> dict:
    """Phase 28: the five baselines through ``cli validate`` on the card, a
    profiler pass over a set, one batch each card against CPU, and the four
    golden fixtures of the original baselines on the card."""
    import shutil

    from tests.torch_golden_replay import BASELINE_CASES

    t0 = time.perf_counter()
    shutil.rmtree(BASELINE_DIR, ignore_errors=True)
    roots = baseline_roots()
    print(f"baselines: roots {time.perf_counter() - t0:.1f} s (phase 25's "
          f"COCO image root; a VOC root of {BASELINE_VOC_IMAGES} JPEGs)")
    launches = {}
    for name, path, sets, root in BASELINE_FILES:
        for k, v in baseline_file_pass(name, path, sets, roots[root],
                                       BASELINE_DIR).items():
            launches[k] = launches.get(k, 0) + v
    check(not nonzero(launches), f"baselines: kernel launches "
          f"{nonzero(launches)}")
    replay_golden(BASELINE_CASES)
    print(f"baselines: phase 28 took {time.perf_counter() - t0:.1f} s")
    return launches


# phase 29: the Swin-B DCAMA and the FPTrans baselines through ``cli
# validate`` at the full width and depth of their files (Swin-B at 384 px;
# two ViT-B/16 of depth 10 at 480 px), and DCAMA's training recipe through
# ``cli run``; seeded weights, fp32 (the files set no dtype)
SWIN_VIT_FILES = (
    ("dcama", "parameters/validation/COCO/dcama.yaml",
     ("val_coco20i_N1K1", "val_coco20i_N2K1"), "coco"),
    ("fptrans", "parameters/validation/COCO/fptrans_1shot.yaml",
     ("val_coco20i_N1K1",), "coco"),
    # no data_dir in the Pascal file (ROADMAP C12): the VOC root's
    ("fptrans_pascal", "parameters/validation/Pascal/fptrans.yaml",
     ("val_pascal5i_N1K1",), "voc"),
)
DCAMA_TRAIN_YAML = "parameters/trainval/coco20i/dcama.yaml"
DCAMA_STEPS = 4
DCAMA_TUPLE = [2, 1, 2]           # one of the file's: 2 episodes, 1-way 2-shot
DCAMA_LOSS_RTOL = 2e-3


def dcama_train_config(paths: dict, steps: int = DCAMA_STEPS) -> dict:
    """``trainval/coco20i/dcama.yaml``'s first grid point on the image root:
    one epoch of ``steps`` steps at DCAMA_TUPLE, no validation set, 16
    loader threads; the file's SGD, warm-up and prompt types as they are."""
    from labelanything_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(DCAMA_TRAIN_YAML)
    cfg.pop("other_grids")
    p = cfg["parameters"]
    datasets = p["dataset"]["datasets"]
    for name in list(datasets):
        if name.startswith("val_"):
            del datasets[name]
        else:
            datasets[name].update({k: [v] for k, v in paths.items()})
    p["train_params"]["max_epochs"] = [1]
    p["logger"]["log_frequency"] = [1]
    p["dataloader"].update(num_steps=[steps], num_workers=[16],
                           possible_batch_example_nums=[[DCAMA_TUPLE]])
    return cfg


def step_losses(run) -> list:
    """The loss of each of ``run``'s train steps from now on."""
    losses, step = [], run.train_step

    def recorded(*args, **kw):
        state, aux = step(*args, **kw)
        losses.append(aux["loss"].detach())
        return state, aux

    run.train_step = recorded
    return losses


def dcama_train(paths: dict) -> None:
    """``cli run`` of DCAMA's recipe for DCAMA_STEPS SGD steps, then the
    first step of the same batch card against CPU."""
    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.experiment import run as run_mod
    from labelanything_tpu_torch.utils.config import expand_experiment

    t1 = time.perf_counter()
    out = f"{SWIN_VIT_DIR}/dcama_run"
    params = write_params(dcama_train_config(paths), f"{out}.yaml")
    steps, make_step = [], run_mod.make_train_step

    def timed_make(**kw):
        step = make_step(**kw)

        def timed(state, batch, gt, *args, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = step(state, batch, gt, *args, **k)
            torch.cuda.synchronize()
            steps.append(dict(
                images=int(np.prod(batch[BatchKeys.IMAGES].shape[:2])),
                ms=(time.perf_counter() - t) * 1e3))
            return result
        return timed

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(run_mod, "make_train_step", timed_make):
        rc = cli_main(["run", "--parameters", params, "--out-dir", out],
                      f"{out}.out")
    t_cli = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(rc == 0, f"dcama run: the CLI returned {rc}")
    losses = [r["train/loss"] for r in read_jsonl(f"{out}/metrics.jsonl")
              if "train/loss" in r]
    check(len(steps) == DCAMA_STEPS and len(losses) == DCAMA_STEPS
          and all(np.isfinite(losses)), f"dcama run: {len(steps)} steps, "
          f"losses {losses}")

    # the first step, card against CPU, from the card's weights
    flat = expand_experiment(dcama_train_config(paths, 1))[0]
    gpu = Run().init(flat, f"{SWIN_VIT_DIR}/dcama_card", device="cuda")
    cpu = Run().init(flat, f"{SWIN_VIT_DIR}/dcama_cpu", device="cpu")
    cpu.state.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.state.model.state_dict().items()})
    l_gpu, l_cpu = step_losses(gpu), step_losses(cpu)
    t2 = time.perf_counter()
    gpu.train_epoch(0)
    cpu.train_epoch(0)
    t_parity = time.perf_counter() - t2
    gpu.close()
    cpu.close()
    del gpu, cpu
    torch.cuda.empty_cache()
    l_gpu, l_cpu = float(l_gpu[0]), float(l_cpu[0])
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    step_ms = [round(s["ms"], 1) for s in steps]
    late = step_ms[1:]
    print(f"dcama run: Swin-B DCAMA fp32 at 384 px, SGD, {DCAMA_STEPS} steps "
          f"of {DCAMA_TUPLE} (" + ", ".join(str(s["images"]) for s in steps)
          + f" images): step ms {step_ms}, {len(late) / (sum(late) / 1e3):.2f}"
          f" steps/s after the first; the CLI call {t_cli:.1f} s; peak "
          f"{peak:.2f} GiB; losses " + ", ".join(f"{x:.5f}" for x in losses)
          + f"; the first step's loss card {l_gpu:.6f} / CPU {l_cpu:.6f} "
          f"(relative {rel:.2e}, {t_parity:.1f} s)")
    check(rel <= DCAMA_LOSS_RTOL, f"dcama parity: loss {l_gpu} / {l_cpu}")


def phase_swin_vit_baselines() -> dict:
    """Phase 29: DCAMA (Swin-B) and FPTrans through ``cli validate`` on the
    card, each with a profiler pass over a set and one batch card against
    CPU; DCAMA's SGD recipe through ``cli run``, its first step card
    against CPU; the three golden fixtures of the original Swin, DCAMA and
    FPTrans on the card. The path launches no kernel of the port: Swin's
    windows (144 tokens), DCAMA's mask aggregation and FPTrans's 901 and
    973 tokens are all outside K6's rule."""
    import shutil

    from tests.torch_golden_replay import TRANSFORMER_CASES

    t0 = time.perf_counter()
    shutil.rmtree(SWIN_VIT_DIR, ignore_errors=True)
    roots = baseline_roots()
    launches = {}
    for name, path, sets, root in SWIN_VIT_FILES:
        for k, v in baseline_file_pass(name, path, sets, roots[root],
                                       SWIN_VIT_DIR).items():
            launches[k] = launches.get(k, 0) + v
    check(not nonzero(launches), f"swin / vit baselines: kernel launches "
          f"{nonzero(launches)}")
    print(f"swin / vit baselines: K6 launches on these paths "
          f"{launches.get(FLASH['name'], 0)}")
    fa.reset_launches()
    dcama_train(roots["coco"])
    check(not nonzero(dict(fa.LAUNCHES)), f"dcama run: kernel launches "
          f"{nonzero(dict(fa.LAUNCHES))}")
    replay_golden(TRANSFORMER_CASES)
    print(f"swin / vit baselines: phase 29 took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# phase 30: the LAM variants of 19 files of parameters/ (OneWay / Identity
# fusion, class_embedding_dim and PrototypeAffinity, embeddings per example,
# TokenPool, classification_levels, conv_classification, dropout), each at
# its own image_size / image_embed_dim / embed_dim with seeded weights.
# Each distinct model block of a trainval file trains VARIANT_STEPS steps
# through Run at VARIANT_TUPLE (1 episode, 1 class, 2 examples: the first
# step's loss card against CPU, within VARIANT_LOSS_RTOL), validates
# VARIANT_VAL episodes a set (finite metrics), and the first episode of a
# validation batch goes through the fp32 model on both
# (variant_logits_agree); a validation file's grid point takes the
# checkpoint of a run of its model block (VARIANT_EXTRA blocks have no
# trainval file among the 19 and get a run of their own, on
# VARIANT_EXTRA_FROM's set-up). Caches: phase 20's COCO root and phase 22's
# VOC root at 480 px (30 x 30), and roots of VARIANT_IMAGES_1024 images at
# 1024 px (64 x 64; VARIANT_CATEGORIES COCO categories).
VARIANT_DIR = "build/variants_run"
VARIANT_CARD = "cuda"        # the device measured against the CPU
VARIANT_STEPS, VARIANT_VAL = 3, 2
VARIANT_TUPLE = [1, 1, 2]
VARIANT_LOSS_RTOL = 2e-3
VARIANT_IMAGES_1024 = 64
VARIANT_CATEGORIES = 16
VARIANT_TRAIN = (
    ("trainval/Ablations/mae_transformer.yaml", "voc"),
    ("trainval/other/COCO_complete_256_oneway.yaml", "coco1024"),
    ("trainval/other/COCO_mae_oneway256.yaml", "coco"),
    ("trainval/other/Pascal/PASCAL_identity.yaml", "voc1024"),
    ("trainval/other/Affinity/4.3_AFClass_SAM.yaml", "coco1024"),
    ("trainval/other/Affinity/4.3.1_AFClass_MAE.yaml", "coco"),
    ("trainval/other/Affinity/4.3.2_AFClass_MAE_noconvs.yaml", "coco"),
    ("trainval/other/Affinity/4.4_AffinityPrototype.yaml", "coco"),
    ("trainval/pascal/mae_chooser.yaml", "voc"),
    ("trainval/pascal/mae_multiemb.yaml", "voc"),
    ("trainval/coco20i/mae_pool.yaml", "coco"),
    ("trainval/pascal/mae_pool.yaml", "voc"),
    ("trainval/pascal/mae_levels.yaml", "voc"),
    ("trainval/pascal/mae_nodown.yaml", "voc"),
    ("trainval/other/Pascal/PASCAL_dropout.yaml", "voc1024"),
)
VARIANT_VALIDATE = (
    "validation/Ablations/transformer_spatial.yaml",
    "validation/Pascal/mae_multiemb.yaml",
    "validation/Pascal/mae_cross.yaml",
    "validation/Pascal/mae_levels.yaml",
)
VARIANT_EXTRA_FROM = "trainval/pascal/mae_multiemb.yaml"
# 4.3_AFClass_SAM.yaml's transformer_feature_size 40 is not the 64 x 64
# grid: the JAX package cannot run it (ROADMAP C3); it runs on the grid
VARIANT_MODEL = {"trainval/other/Affinity/4.3_AFClass_SAM.yaml":
                 {"transformer_feature_size": [None]}}
VARIANT_K6 = "trainval/other/Affinity/4.3_AFClass_SAM.yaml"


def variant_roots() -> dict:
    """The caches of phase 30: phase 20's and phase 22's 480-px roots
    (written where missing) and the 1024-px ones."""
    from labelanything_tpu_torch.data.synthetic_coco import (
        COCO_CATEGORY_IDS, write_synthetic_coco)
    from labelanything_tpu_torch.data.synthetic_voc import write_synthetic_voc

    coco = mae_paths()
    if not os.path.exists(coco["instances_path"]):
        coco = write_synthetic_coco(f"{MAE_DIR}/coco", seed=SEED,
                                    num_images=MAE_IMAGES)
    voc_dir = f"{VOC_DIR}/voc"
    voc = {"data_dir": voc_dir, "emb_dir": f"{voc_dir}/embeddings"}
    if not os.path.exists(voc["emb_dir"]):
        voc = write_synthetic_voc(voc_dir, seed=SEED, num_images=VOC_IMAGES)
    coco1024 = write_synthetic_coco(
        f"{VARIANT_DIR}/coco1024", seed=SEED, num_images=VARIANT_IMAGES_1024,
        grid=64, category_ids=COCO_CATEGORY_IDS[:VARIANT_CATEGORIES])
    # half of the names validate, 2 or 3 classes a mask: each of a fold's
    # classes then shows in a few validation images, as N1K1 needs
    voc1024 = write_synthetic_voc(f"{VARIANT_DIR}/voc1024", seed=SEED,
                                  num_images=VARIANT_IMAGES_1024, grid=64,
                                  classes_per_image=(2, 3), val_share=0.5)
    pick = lambda d, keys: {k: d[k] for k in keys}
    return {"coco": pick(coco, ("instances_path", "emb_dir")),
            "coco1024": pick(coco1024, ("instances_path", "emb_dir")),
            "voc": pick(voc, ("data_dir", "emb_dir")),
            "voc1024": pick(voc1024, ("data_dir", "emb_dir"))}


def variant_config(path: str, paths: dict, model: dict = None) -> dict:
    """``path`` on ``paths`` (protocol_config, VARIANT_VAL episodes a set)
    cut to one epoch of VARIANT_STEPS steps at VARIANT_TUPLE, a log line
    a step; ``model`` updates the model block."""
    cfg = protocol_config(f"parameters/{path}", paths, VARIANT_VAL,
                          model=model)
    p = cfg["parameters"]
    for d in p["dataset"]["datasets"].values():
        if "val_num_samples" in d and "split" not in d:
            # the whole-COCO dataset (no folds) counts its episodes so
            d["num_samples"] = d.pop("val_num_samples")
    p.setdefault("train_params", {})["max_epochs"] = [1]
    p.setdefault("logger", {})["log_frequency"] = [1]
    p["dataloader"].update(num_steps=[VARIANT_STEPS], num_workers=[8],
                           possible_batch_example_nums=[[VARIANT_TUPLE]])
    return cfg


def model_key(block: dict) -> str:
    return json.dumps({k: v for k, v in block.items() if k != "checkpoint"},
                      sort_keys=True, default=str)


def draws_masks(model: torch.nn.Module) -> bool:
    """Whether a train()-mode forward draws random masks: dropout, or the
    cross-attention extraction's embedding dropout (their streams differ
    between the card's generator and the CPU's)."""
    from labelanything_tpu_torch.models.common import Dropout
    from labelanything_tpu_torch.models.prompt_encoder import \
        EmbeddingTransformer

    return any((isinstance(m, Dropout) and m.rate > 0)
               or (isinstance(m, EmbeddingTransformer)
                   and m.embedding_dropout > 0) for m in model.modules())


def variant_logits_agree(gpu: torch.Tensor, cpu: torch.Tensor,
                         what: str) -> tuple:
    """The card's fp32 logits against the CPU's: the same non-finite
    entries (the pad band, classes that no example flags; two
    classification levels merge such a class's -inf into NaN, taken as
    -inf here), the finite ones within rtol 1e-3 / atol 5e-4, and the
    argmax equal at every decisive pixel: where the CPU's two largest
    logits part by more than twice the tolerance at the largest, so that
    no difference the tolerance admits can swap them. (With seeded
    weights the pooler's classes tie to 1e-3 on nearly every pixel, and
    phase 28's share of agreeing pixels would count rounding.) Returns
    (max |card - cpu|, the logits' scale, the argmax agreement over all
    pixels, the decisive pixels' share)."""
    g, c = (torch.where(torch.isnan(x), float("-inf"), x.float()).cpu()
            .numpy() for x in (gpu, cpu))
    finite = np.isfinite(c)
    check(np.array_equal(np.isfinite(g), finite) and finite.any(),
          f"{what}: the non-finite logits differ")
    diff = float(np.abs(g[finite] - c[finite]).max())
    check(np.allclose(g[finite], c[finite], rtol=1e-3, atol=5e-4),
          f"{what}: logits card / cpu differ by up to {diff:.3g}")
    top2 = np.sort(c, axis=1)[:, -2:]
    with np.errstate(invalid="ignore"):
        gap = top2[:, 1] - top2[:, 0]
    decisive = np.isfinite(top2[:, 1]) & (
        np.nan_to_num(gap, nan=0.0, posinf=np.inf)
        > 2 * (5e-4 + 1e-3 * np.abs(top2[:, 1])))
    same = g.argmax(1) == c.argmax(1)
    check(same[decisive].all(), f"{what}: the argmax differs at "
          f"{int((~same & decisive).sum())} decisive pixels")
    return (diff, float(np.abs(c[finite]).max()), float(same.mean()),
            float(decisive.mean()))


def variant_train(label: str, flat: dict, out: str) -> dict:
    """One model block: VARIANT_STEPS steps through ``Run`` on the card,
    its checkpoint, validation, the first step's loss and one validation
    batch's logits card (fp32) against CPU, a dropout mask's keep rate;
    printed on one line. Returns the launches and the checkpoint dir."""
    import copy

    from labelanything_tpu_torch.api import build_on_device
    from labelanything_tpu_torch.experiment import Run
    from labelanything_tpu_torch.experiment import run as run_mod
    from labelanything_tpu_torch.models.common import (Dropout,
                                                       dropout_generator)
    from labelanything_tpu_torch.parallel.train_step import \
        pass_dropout_generator
    from labelanything_tpu_torch.train.substitutor import divide_query_examples
    from labelanything_tpu_torch.typing import LossDict

    t0 = time.perf_counter()
    sites = {}
    with mock.patch.object(run_mod, "build_on_device", site_counter(sites)):
        run = Run().init(flat, out, device=VARIANT_CARD)
    model = run.state.model
    start = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    first, losses, step = {}, [], run.train_step

    def recorded(state, batch, gt, generator, *args, **kw):
        if not first:
            first.update(batch={k: v.detach().cpu().clone()
                                for k, v in batch.items()},
                         gt=torch.as_tensor(gt).cpu().clone(),
                         rows=generator.get_state().clone())
        state, aux = step(state, batch, gt, generator, *args, **kw)
        losses.append(aux["loss"].detach())
        return state, aux

    run.train_step = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t1 = time.perf_counter()
    run.train_epoch(0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t1
    launches, site_launches = dict(fa.LAUNCHES), dict(sites)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    # a file that substitutes takes a pass an example and one more a batch
    check(len(losses) >= VARIANT_STEPS and all(np.isfinite(losses)),
          f"{label}: losses {losses}")
    run.checkpoints.save_latest(run.state, 0, run.generator)
    metrics = run.validate(0)
    check(metrics and all(np.isfinite(list(metrics.values()))),
          f"{label}: validation metrics {metrics}")

    # fp32 on both sides from the starting weights: the first step's loss
    # (its batch and class rows) and one validation batch's logits
    # the Run's block: its unpad rule is the dataset's (custom_preprocess)
    block = dict(flat["model"], dtype="float32",
                 custom_preprocess=model.custom_preprocess)
    block.pop("checkpoint", None)
    models = {}
    for side, dev in (("card", VARIANT_CARD), ("cpu", "cpu")):
        m = build_on_device(block, dev, seed=None)
        m.load_state_dict({k: v.to(dev) for k, v in start.items()})
        models[side] = (m, dev)
    parity = {}
    masks = draws_masks(models["cpu"][0])
    if not masks:
        for side, (m, dev) in models.items():
            rows = torch.Generator()
            rows.set_state(first["rows"])
            loss_mod = copy.deepcopy(run.state.loss).to(dev)
            with torch.no_grad():
                result = m.train()({k: v.to(dev) for k, v in
                                    first["batch"].items()}, rows)
                parity[side] = float(loss_mod(result, first["gt"].to(dev))[
                    LossDict.VALUE])
        rel = abs(parity["card"] - parity["cpu"]) / abs(parity["cpu"])
        check(rel <= VARIANT_LOSS_RTOL,
              f"{label}: first loss card {parity['card']} / cpu "
              f"{parity['cpu']}")
        if flat["model"].get("dtype", "float32") == "float32":
            # the fp32 Run's own first step took the same batch and rows
            check(abs(losses[0] - parity["card"]) <= 1e-5 * abs(losses[0]),
                  f"{label}: the Run's first loss {losses[0]} / its "
                  f"recomputation {parity['card']}")
    loader = next(iter(run.val_loaders.values()))
    (batch, _), _ = next(iter(loader))
    device_batch, _ = run._device_batch(batch, example_rows=slice(1, None))
    inputs, _ = divide_query_examples(device_batch)
    inputs = {k: v[:1] for k, v in inputs.items()}     # its first episode
    with torch.no_grad():
        gpu = models["card"][0].eval()(inputs)[ResultDict.LOGITS]
        cpu = models["cpu"][0].eval()(
            {k: v.cpu() for k, v in inputs.items()})[ResultDict.LOGITS]
    diff, scale, agree, decisive = variant_logits_agree(gpu, cpu, label)
    keep = ""
    rates = sorted({m.rate for m in model.modules()
                    if isinstance(m, Dropout) and m.rate > 0})
    if rates:
        drop = Dropout(rates[0]).train()
        n = 10 ** 6
        card = torch.device(VARIANT_CARD)
        with dropout_generator(pass_dropout_generator(run.state, card)):
            kept = int((drop(torch.ones(n, device=card)) != 0).sum())
        sd = (n * rates[0] * (1 - rates[0])) ** 0.5
        check(abs(kept - n * (1 - rates[0])) < 5 * sd,
              f"{label}: a dropout mask kept {kept} of {n} at rate "
              f"{rates[0]}")
        keep = (f"; a card dropout mask at rate {rates[0]} keeps {kept} of "
                f"{n} ({(kept - n * (1 - rates[0])) / sd:+.2f} sd)")
    ckpt = f"{out}/checkpoints"
    run.close()
    del run, model, models
    torch.cuda.empty_cache()
    m = flat["model"]
    loss_txt = ("the train step draws dropout masks: loss not compared, "
                "eval() logits are" if masks else
                f"first loss card {parity['card']:.6f} / CPU "
                f"{parity['cpu']:.6f} (fp32)")
    site_txt = (f", K7 by call site {site_launches}"
                if any(site_launches.values()) else "")
    print(f"variants: {label} ({m.get('image_size')} px, "
          f"{m.get('image_embed_dim')} -> {m.get('embed_dim')}, "
          f"{m.get('dtype', 'float32')}): {VARIANT_STEPS} batches, "
          f"{len(losses)} passes in {t_train:.2f} s ({len(losses) / t_train:.2f}"
          f" passes/s, the first included), peak {peak:.2f} GiB, losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + f", launches {nonzero(launches)}{site_txt}; validation "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())
                      if k.endswith("miou") and not k.endswith("bmiou"))
          + f"; {loss_txt}; one batch {tuple(gpu.shape)} card / CPU max "
          f"|diff| {diff:.3g} at scale {scale:.3g}, argmax {agree:.6f} "
          f"(decisive pixels {decisive:.6f} of the frame, all agreeing)"
          f"{keep}; {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "checkpoint": ckpt}


def phase_lam_variants() -> dict:
    """Phase 30: the LAM variants of 19 files of ``parameters/``: every
    distinct model block of the 15 trainval files through ``Run`` on the
    card (variant_train), then the 4 validation files through ``cli
    validate --checkpoint``, each grid point from the checkpoint of a run
    of its model block, with a ``data_dir`` (C12). K6 must launch in
    4.3_AFClass_SAM's model at 1024 px; K7's launches of the bf16
    coco20i/mae_pool.yaml are counted by call site; the other fp32 files
    launch no kernel."""
    import shutil

    from labelanything_tpu_torch.utils.config import (expand_experiment,
                                                      load_yaml)

    t0 = time.perf_counter()
    shutil.rmtree(VARIANT_DIR, ignore_errors=True)
    roots = variant_roots()
    t_roots = time.perf_counter() - t0
    path_launches, runs = {}, {}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            path_launches[k] = path_launches.get(k, 0) + v

    for path, root in VARIANT_TRAIN:
        cfg = variant_config(path, roots[root], VARIANT_MODEL.get(path))
        seen = set()
        for i, flat in enumerate(expand_experiment(cfg)):
            key = model_key(flat["model"])
            if key in seen:
                continue
            seen.add(key)
            label = f"{path.split('/')[-1]}[{i}]"
            out = variant_train(label, flat, f"{VARIANT_DIR}/{len(runs)}")
            launches = nonzero(out["launches"])
            if path == VARIANT_K6:
                check(any(k.startswith("flash") for k in launches),
                      f"{label}: no K6 launch at 1024 px ({launches})")
            elif flat["model"].get("dtype", "float32") == "float32":
                check(not launches, f"{label}: fp32 launches {launches}")
            add(out["launches"])
            runs.setdefault(key, out["checkpoint"])

    for path in VARIANT_VALIDATE:
        # the 1-shot sets: a synthetic VOC root's validation names hold too
        # few images of a class for 5 shots
        sets = [n for n in load_yaml(f"parameters/{path}")["parameters"][
            "dataset"]["datasets"] if n.endswith("K1")]
        cfg = protocol_config(f"parameters/{path}", roots["voc"], VARIANT_VAL,
                              sets=sets)
        params = write_params(cfg, f"{VARIANT_DIR}/{path.split('/')[-1]}")
        for i, flat in enumerate(expand_experiment(cfg)):
            key = model_key(flat["model"])
            label = f"{path.split('/')[-1]}[{i}]"
            if key not in runs:
                # a run of this block on a trainval file's set-up
                extra = variant_config(
                    VARIANT_EXTRA_FROM, roots["voc"],
                    {k: [v] for k, v in flat["model"].items()
                     if k != "checkpoint"})
                out = variant_train(f"{label} (its own run)",
                                    expand_experiment(extra)[0],
                                    f"{VARIANT_DIR}/{len(runs)}")
                check(not nonzero(out["launches"]),
                      f"{label}: fp32 launches {out['launches']}")
                runs[key] = out["checkpoint"]
            t = time.perf_counter()
            fa.reset_launches()
            out_dir = f"{VARIANT_DIR}/{label}"
            rc = cli_main(["validate", "--parameters", params, "--checkpoint",
                           runs[key], "--folds", str(i), "--reruns", "1",
                           "--out-dir", out_dir], f"{out_dir}.out")
            check(rc == 0, f"{label}: cli validate returned {rc}")
            check(not nonzero(dict(fa.LAUNCHES)),
                  f"{label}: launches {nonzero(dict(fa.LAUNCHES))}")
            with open(f"{out_dir}/results.json") as f:
                results = json.load(f)
            values = [v for k, v in results.items()
                      if k.startswith(f"fold{i}/")]
            check(values and all(np.isfinite(values)),
                  f"{label}: results {results}")
            print(f"variants: {label} cli validate --checkpoint "
                  f"{runs[key]} --folds {i}: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(results.items())
                      if k.endswith("_miou"))
                  + f"; {time.perf_counter() - t:.1f} s")
    print(f"variants: roots {t_roots:.1f} s; {len(runs)} model blocks "
          f"trained; launches on these paths {nonzero(path_launches)}; "
          f"phase 30 took {time.perf_counter() - t0:.1f} s")
    return path_launches


def main() -> None:
    card = phase_card()
    kind = torch.cuda.get_device_name(0)
    phase_build()
    t0 = time.perf_counter()

    def clock(label: str) -> None:
        print(f"clock: phases to {label} done {time.perf_counter() - t0:.1f} "
              f"s after the build")

    kernel_stats = phase_kernels()
    clock("2")
    phase_parity()
    clock("3")
    # each main path is driven with the counters set to 0 just before it
    # and read just after; a kernel's launches are summed over them
    launches, logits_b = phase_serve(profile=True)
    paths = [launches]
    phase_step_parity()
    clock("5")
    paths.append(phase_train())
    clock("6")
    phase_vit_h_parity()
    clock("7")
    paths.append(phase_serve(CONFIG_H, ENCODER_LAUNCHES_H, profile=True)[0])
    paths.append(phase_serve(CONFIG_L, ENCODER_LAUNCHES_L, shots=1,
                             requests=1)[0])
    paths.append(phase_embed(build_vit_h, "vit_h", ENCODER_LAUNCHES_H)[0])
    paths.append(phase_embed(build_vit_l, "vit_l", ENCODER_LAUNCHES_L)[0])
    clock("9")
    phase_decode_parity()
    clock("10")
    paths.append(phase_decode())
    clock("11")
    phase_affinity_parity()
    clock("12")
    paths.append(phase_affinity())
    clock("13")
    phase_options_parity()
    clock("14")
    paths += phase_options_serve(logits_b)
    clock("15")
    phase_golden()
    clock("16")
    paths.append(phase_flagship())
    clock("17")
    paths.append(phase_affinity_train())
    clock("18")
    paths.append(phase_workflow()[0])
    clock("19")
    paths.append(phase_mae_run())
    clock("20")
    paths.append(phase_eval())
    clock("21")
    paths.append(phase_pascal())
    clock("22")
    paths.append(phase_test_protocol())
    clock("23")
    phase_image_decode()
    clock("24")
    paths.append(phase_generate_embeddings())
    clock("25")
    paths.append(phase_vit_run())
    clock("26")
    paths.append(phase_crossdomain())
    clock("27")
    paths.append(phase_baselines())
    clock("28")
    paths.append(phase_swin_vit_baselines())
    clock("29")
    paths.append(phase_lam_variants())
    clock("30")
    print(f"profiler passes made again for a lost guard: "
          f"{time_kernels.guard_overruns}")
    summary = []
    for k in (KERNELS + PACKED_KERNELS + VARIANT_KERNELS
              + [TWOWAY, FLASH, FUSED_WINDOW, INT8]):
        stats = dict(kernel_stats[k["name"]])
        # the variants' main path is the microbench, counted in phase 2
        launches = stats.pop("launches", None)
        if launches is None:
            launches = sum(path.get(k["name"], 0) for path in paths)
        check(launches > 0, f"{k['name']} was launched on no main path")
        # the bound over the device time, where the device's was taken
        share = (stats["bound_ms"] / stats["device_ms"]
                 if "device_ms" in stats else None)
        summary.append(dict(name=k["name"], route="cuda", source=k["source"],
                            replaces=k["replaces"], launches=launches,
                            bound_share=share, **stats))
    print("share of the bound on the device: " + ", ".join(
        f"{s['name']} " + ("not measured" if s["bound_share"] is None
                           else f"{s['bound_share']:.3f}")
        for s in summary))
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
