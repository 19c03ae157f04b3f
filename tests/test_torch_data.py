"""The port's episode engine against the JAX package's, on the CPU: the RLE
codec, the polygon fill without PIL against the JAX ``rle`` functions (which
draw with PIL), the nearest-resize index map, ``PromptsProcessor`` under one
generator, and the first batches of ``LabelAnythingDataset`` +
``VariableBatchSampler`` + ``EpisodeLoader`` on a synthetic COCO root,
compared key by key and bit for bit (train split of a COCO-20i fold and the
val split; thread mode and process mode)."""

import itertools
import pathlib

import numpy as np
import pytest

from labelanything_tpu.data import coco as jcoco
from labelanything_tpu.data import dataset as jds
from labelanything_tpu.data import loader as jloader
from labelanything_tpu.data import rle as jrle
from labelanything_tpu.data import transforms as jtf
from labelanything_tpu.typing import BatchMetadataKeys, PromptType
from labelanything_tpu_torch.data import dataset as tds
from labelanything_tpu_torch.data import loader as tloader
from labelanything_tpu_torch.data import rle as trle
from labelanything_tpu_torch.data import transforms as ttf
from labelanything_tpu_torch.data.synthetic_coco import (COCO_CATEGORY_IDS,
                                                         write_synthetic_coco)
from labelanything_tpu_torch.utils.config import load_yaml

REPO = pathlib.Path(__file__).resolve().parents[1]
EPISODE_TYPES = BatchMetadataKeys.PROMPT_TYPES


# -- RLE and polygons --------------------------------------------------------- #

def test_rle_codec_matches_jax():
    rng = np.random.default_rng(0)
    for h, w in [(1, 1), (7, 5), (31, 40), (64, 48)]:
        masks = [(rng.random((h, w)) < p).astype(np.uint8)
                 for p in (0.0, 0.3, 1.0)]
        for m in masks:
            enc, jenc = trle.encode(m), jrle.encode(m)
            assert enc == jenc
            assert np.array_equal(trle.decode(jenc), jrle.decode(jenc))
            assert np.array_equal(trle.decode(enc), m)
        assert trle.merge([trle.encode(m) for m in masks]) == jrle.merge(
            [jrle.encode(m) for m in masks])


def _rectangle(rng, h, w):
    x0, y0 = rng.uniform(-4, w), rng.uniform(-4, h)
    x1, y1 = x0 + rng.uniform(1, w), y0 + rng.uniform(1, h)
    return [x0, y0, x1, y0, x1, y1, x0, y1]


def _triangle(rng, h, w):
    return list(rng.uniform([0, 0] * 3, [w, h] * 3))


def _concave(rng, h, w):
    """A star-shaped polygon: vertices at sorted angles, radii that jump."""
    k = int(rng.integers(5, 16))
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = rng.uniform(0.2, 1.0, k) * min(h, w) / 2
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    return [v for a, r in zip(ang, rad)
            for v in (cx + r * np.cos(a), cy + r * np.sin(a))]


def _self_touching(rng, h, w):
    """Two triangles sharing one vertex (a bow tie), or a square with a
    notch whose tip touches the opposite side."""
    cx, cy = rng.uniform(w / 4, 3 * w / 4), rng.uniform(h / 4, 3 * h / 4)
    a, b = rng.uniform(2, w / 3), rng.uniform(2, h / 3)
    if rng.random() < 0.5:
        return [cx, cy, cx - a, cy - b, cx - a, cy + b, cx, cy,
                cx + a, cy + b, cx + a, cy - b]
    return [cx - a, cy - b, cx + a, cy - b, cx + a, cy + b, cx, cy + b,
            cx, cy - b, cx - a / 2, cy + b, cx - a, cy + b]


SHAPES = {"rectangle": _rectangle, "triangle": _triangle,
          "concave": _concave, "self_touching": _self_touching}


@pytest.mark.parametrize("vertices", ["integer", "float"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_poly_to_mask_matches_pil(shape, vertices):
    """Equal pixel for pixel on 300 seeded polygons of the kind, the border
    crossed by some of them (vertices from 1/8 of a side outside)."""
    rng = np.random.default_rng(sorted(SHAPES).index(shape) * 2
                                + (vertices == "float"))
    for _ in range(300):
        h, w = int(rng.integers(6, 90)), int(rng.integers(6, 90))
        poly = [float(v) for v in SHAPES[shape](rng, h, w)]
        if rng.random() < 0.3:     # shift across the border
            poly = [v + (rng.uniform(-1, 1) * (w if i % 2 == 0 else h) / 8)
                    for i, v in enumerate(poly)]
        if vertices == "integer":
            poly = [float(round(v)) for v in poly]
        got = trle.poly_to_mask([poly], h, w)
        expected = jrle.poly_to_mask([poly], h, w)
        assert np.array_equal(got, expected), (shape, poly, h, w)


def test_ann_to_mask_matches_jax():
    """Polygon lists (two parts), a degenerate polygon (its one-pixel
    fallback), uncompressed and compressed RLE, an empty RLE."""
    rng = np.random.default_rng(5)
    h, w = 37, 53
    m = (rng.random((h, w)) < 0.4).astype(np.uint8)
    runs = trle._counts_to_array(trle.encode(m)["counts"]).tolist()
    cases = [
        [_concave(rng, h, w), _triangle(rng, h, w)],
        [[10.4, 3.2, 10.4, 3.2, 10.4, 3.2]],
        [[-5.0, 60.0, -3.0, 61.0, -4.0, 70.0]],
        {"size": [h, w], "counts": runs},
        trle.encode(m),
        trle.encode(np.zeros((h, w), np.uint8)),
    ]
    for segm in cases:
        assert np.array_equal(trle.ann_to_mask(segm, h, w),
                              jrle.ann_to_mask(segm, h, w)), segm


# -- resize maps and prompts ------------------------------------------------ #

def test_nearest_index_map_matches_pil():
    for n_dst in (30, 64, 120, 256, 480, 1024):
        for n_src in range(1, 1101):
            assert np.array_equal(ttf.nearest_index_map(n_src, n_dst),
                                  jtf.nearest_index_map(n_src, n_dst)), (
                n_src, n_dst)


@pytest.mark.parametrize("custom", [True, False])
def test_prompts_processor_matches_jax(custom):
    """Boxes with noise, points, coordinate frames, the gather form of
    ``apply_masks`` and ``gt_to_input_frame``, both drawing from one seed."""
    for h, w in [(427, 640), (640, 480), (64, 48), (30, 30)]:
        args = dict(long_side_length=480 if h > 64 else 64,
                    masks_side_length=256, custom_preprocess=custom)
        tp = ttf.PromptsProcessor(rng=np.random.default_rng(h), **args)
        jp = jtf.PromptsProcessor(rng=np.random.default_rng(h), **args)
        mrng = np.random.default_rng(w)
        masks = [(mrng.random((h, w)) < 0.1).astype(np.uint8)
                 for _ in range(3)]
        box = [w * 0.1, h * 0.2, w * 0.5, h * 0.3]
        for noise in (False, True):
            assert tp.convert_bbox(box, h, w, noise) == jp.convert_bbox(
                box, h, w, noise)
        assert tp.sample_points(masks[0], 7) == jp.sample_points(masks[0], 7)
        coords = mrng.uniform(0, 400, (5, 2))
        assert np.array_equal(tp.apply_coords(coords, (h, w)),
                              jp.apply_coords(coords, (h, w)))
        boxes = mrng.uniform(0, 400, (3, 4))
        assert np.array_equal(tp.apply_boxes(boxes, (h, w)),
                              jp.apply_boxes(boxes, (h, w)))
        got = tp.apply_masks(masks)
        assert np.array_equal(got, jp.apply_masks(masks))
        assert np.array_equal(got, jp.apply_masks_pil(masks))
        gt = mrng.integers(0, 4, (h, w)).astype(np.int32)
        assert np.array_equal(
            ttf.gt_to_input_frame(gt, args["long_side_length"], custom),
            jtf.gt_to_input_frame(gt, args["long_side_length"], custom))


# -- the episode engine ----------------------------------------------------- #

IMAGE_SIZE = 64


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_coco")
    return write_synthetic_coco(
        str(root), seed=0, num_images=24, embed_dim=48, grid=4,
        sizes=((48, 64), (64, 48), (40, 64), (72, 96)),
        category_ids=COCO_CATEGORY_IDS[:8], classes_per_image=3)


def engine_params(paths, split: str):
    """mae.yaml's dataset and dataloader blocks (first grid point) on the
    synthetic root, at a 64-pixel frame."""
    flat = load_yaml(str(REPO / "parameters/trainval/coco20i/mae.yaml"))
    p = flat["parameters"]
    common = {k: v[0] for k, v in p["dataset"]["common"].items()}
    common.update(image_size=IMAGE_SIZE, remove_small_annotations=False)
    name = "coco20i" if split == "train" else "val_coco20i_N2K1"
    ds = {k: v[0] for k, v in p["dataset"]["datasets"][name].items()}
    ds.update(paths)
    if split == "val":
        ds["val_num_samples"] = 16
    dl = {k: v[0] for k, v in p["dataloader"].items()}
    return {name: ds}, common, dl


class JaxSamplerEpisodeTypesWhole(jds.VariableBatchSampler):
    """The JAX sampler with the fault the port repairs taken out: at the
    "episode" prompt level its prompt types are the one list of
    combinations every episode draws from, which the JAX sampler truncates
    to ``num_steps`` and permutes (raising IndexError when an epoch has
    more batches than combinations). Here the list stays whole, as in the
    port; every other draw is the JAX sampler's own."""

    def __init__(self, data_source, possible_batch_example_nums,
                 prompt_types=None, prompt_choice_level="batch", **kw):
        super().__init__(data_source, possible_batch_example_nums,
                         prompt_types=prompt_types,
                         prompt_choice_level=prompt_choice_level, **kw)
        if prompt_choice_level == "episode":
            prompts = list(prompt_types or [PromptType.BBOX, PromptType.MASK,
                                            PromptType.POINT])
            self.batch_metadata[EPISODE_TYPES] = [
                c for i in range(1, len(prompts) + 1)
                for c in itertools.combinations(prompts, i)]

    def shuffle(self):
        types = self.batch_metadata.pop(EPISODE_TYPES, None)
        super().shuffle()
        if types is not None and self.prompt_choice_level == "episode":
            self.batch_metadata[EPISODE_TYPES] = types


def first_batches(ds_mod, loader_mod, paths, split, n=6, **loader_kw):
    datasets, common, dl = engine_params(paths, split)
    dataset = ds_mod.LabelAnythingDataset(datasets, common)
    sampler_cls = (JaxSamplerEpisodeTypesWhole if ds_mod is jds
                   else ds_mod.VariableBatchSampler)
    if split == "train":
        sampler = sampler_cls(
            dataset, dl["possible_batch_example_nums"],
            prompt_types=dl["prompt_types"],
            prompt_choice_level=dl["prompt_choice_level"][0], shuffle=True,
            seed=42)
    else:
        sampler = sampler_cls(
            dataset, dl["val_possible_batch_example_nums"],
            prompt_types=dl["val_prompt_types"], seed=42)
    if ds_mod is jds:
        # the JAX loader seeds the episodes in process mode only; the
        # dataset's own seed gives thread mode the same stream
        dataset.reseed(42)
    loader = loader_mod.EpisodeLoader(dataset, sampler, seed=42, **loader_kw)
    loader.set_epoch(1)
    out = []
    try:
        for batch in loader:
            out.append(batch)
            if len(out) == n:
                break
    finally:
        loader.close()
    return out


def assert_batches_equal(got, expected):
    assert len(got) == len(expected)
    for ((b, gts), names), ((jb, jgts), jnames) in zip(got, expected):
        assert names == jnames
        assert np.array_equal(gts, jgts) and gts.dtype == jgts.dtype
        assert list(b) == list(jb)
        for key in jb:
            v, jv = b[key], jb[key]
            if isinstance(jv, np.ndarray):
                assert v.dtype == jv.dtype and v.shape == jv.shape, key
                assert np.array_equal(v, jv), key
            else:
                assert v == jv, key


@pytest.fixture
def jax_instances_path(monkeypatch, coco_root):
    """The JAX ``Coco20iDataset`` reads ``self.instances_path``, which its
    ``CocoLVISDataset`` never sets; the class attribute stands in for it."""
    monkeypatch.setattr(jcoco.CocoLVISDataset, "instances_path",
                        coco_root["instances_path"], raising=False)


@pytest.mark.parametrize("split", ["train", "val"])
def test_engine_batches_match_jax(coco_root, jax_instances_path, split):
    expected = first_batches(jds, jloader, coco_root, split, num_workers=2)
    got = first_batches(tds, tloader, coco_root, split, num_workers=2)
    assert len(got) == 6
    assert_batches_equal(got, expected)


def test_engine_process_mode_matches_thread_mode(coco_root):
    threads = first_batches(tds, tloader, coco_root, "train", num_workers=2)
    processes = first_batches(tds, tloader, coco_root, "train", num_workers=2,
                              use_processes=True)
    assert_batches_equal(processes, threads)


def test_pascal_names_raise_until_ported():
    """The Pascal names resolve to the ported datasets (which raise, naming
    ``data_dir``, without a VOC root); the test protocol's cross-domain
    names raise until the port decodes their images."""
    assert tds.resolve_dataset("val_pascal5i_N1K1").__name__ == "Pascal5iDataset"
    assert tds.resolve_dataset("pascal").__name__ == "PascalDataset"
    with pytest.raises(ValueError, match="data_dir"):
        tds.resolve_dataset("val_pascal5i_N1K1")()
    assert tds.resolve_dataset("val_coco20i_N2K1").__name__ == "Coco20iDataset"
    tests = tds.test_registry()
    assert tests["test_coco"].__name__ == "CocoLVISTestDataset"
    for name in ("test_kvasir", "test_kvaris", "test_weedmap", "test_brain",
                 "test_dram"):
        with pytest.raises(NotImplementedError, match="decoder"):
            tests[name]()
