"""The port's PASCAL VOC episode engine against the JAX package's, on the CPU:
``PascalDataset`` and ``Pascal5iDataset`` episodes from the same seed, key
by key and bit for bit, on a synthetic VOC root whose masks PIL writes (the
JAX package reads them with PIL, the port with ``data/png.py``) and whose
embedding caches the port writes; the engine on
``parameters/trainval/pascal/mae.yaml``; and the fault of
``parameters/validation/Pascal/*.yaml`` (no ``data_dir``) on both sides."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from labelanything_tpu.data import dataset as jds
from labelanything_tpu.data import examples as jexamples
from labelanything_tpu.data import loader as jloader
from labelanything_tpu.data import pascal as jpascal
from labelanything_tpu_torch.data import dataset as tds
from labelanything_tpu_torch.data import examples as texamples
from labelanything_tpu_torch.data import loader as tloader
from labelanything_tpu_torch.data import pascal as tpascal
from labelanything_tpu_torch.data.synthetic_voc import write_synthetic_voc
from labelanything_tpu_torch.data.transforms import (get_preprocess_shape,
                                                    normalize_padded)
from labelanything_tpu_torch.typing import BatchMetadataKeys as K
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.safetensors import load_file, save_file
from tests.test_torch_data import (JaxSamplerEpisodeTypesWhole,
                                   assert_batches_equal)
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
IMAGE_SIZE = 64


def sorted_name_draws_in_jax(monkeypatch):
    """C14's repair put on the JAX side: its example generator draws an
    image name from a set in the order of Python's string hash, the port
    from the names sorted."""
    monkeypatch.setattr(jexamples, "uniform_sampling",
                        texamples.uniform_sampling)


@pytest.fixture(autouse=True)
def _c14(monkeypatch):
    sorted_name_draws_in_jax(monkeypatch)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """200 masks of 150 x 200 and 200 x 150 (objects across the 2 x 32 x 32
    that ``remove_small_annotations`` drops), half of them in ``val``,
    written again by PIL; caches 8 wide on a 4 x 4 grid."""
    root = tmp_path_factory.mktemp("synthetic_voc")
    paths = write_synthetic_voc(str(root), seed=5, num_images=200,
                                embed_dim=8, grid=4,
                                sizes=((150, 200), (200, 150)),
                                classes_per_image=(2, 3), val_share=0.5)
    for p in (root / "SegmentationClass").glob("*.png"):
        with Image.open(p) as im:
            im.load()
            arr, palette = np.asarray(im), im.getpalette()
        out = Image.fromarray(arr, mode="P")
        out.putpalette(palette)
        out.save(p)
    return paths


def _pair(voc_root, name, params, common):
    """The JAX and the port's union dataset of one Pascal set."""
    params = {**voc_root, **params}
    common = {"image_size": IMAGE_SIZE, "seed": 11, **common}
    return (jds.LabelAnythingDataset({name: params}, common),
            tds.LabelAnythingDataset({name: params}, common))


def _check_items(jset, tset, metadata, indexes):
    """Episodes ``indexes`` of both datasets, collated in one batch, equal
    bit for bit (each dataset's own ``__getitem__`` seeds the episode)."""
    got = tset.collate_fn([tset[(i, metadata)] for i in indexes])
    expected = jset.collate_fn([jset[(i, metadata)] for i in indexes])
    assert_batches_equal([got], [expected])
    return got


PROMPTS = {"mask": ["mask"], "point": ["point"], "bbox": ["bbox"],
           "all": ["mask", "point", "bbox"]}


@pytest.mark.parametrize("fold", [0, 1, 2, 3])
@pytest.mark.parametrize("ways,shots", [(1, 1), (2, 1), (1, 5), (2, 5)])
def test_pascal5i_val_episodes_match_jax(voc_root, fold, ways, shots):
    """The validation draws (``rng.choice`` without replacement,
    ``rng.integers``) of every fold and way / shot setting; the prompt type
    changes with the case, ``remove_small_annotations`` with the fold."""
    prompts = list(PROMPTS)[(fold + ways + shots) % len(PROMPTS)]
    jset, tset = _pair(voc_root, "val_pascal5i_N1K1",
                       dict(name="pascal", split="val", val_fold_idx=fold,
                            n_folds=4, n_shots=shots, n_ways=ways,
                            do_subsample=False, val_num_samples=6),
                       dict(remove_small_annotations=fold % 2 == 1,
                            custom_preprocess=fold < 2))
    ds = tset.datasets["val_pascal5i_N1K1"]
    jd = jset.datasets["val_pascal5i_N1K1"]
    assert ds.categories == jd.categories and ds.img2cat == jd.img2cat
    assert ds.image_names == jd.image_names and len(ds.categories) >= 2
    batch = _check_items(jset, tset, {K.PROMPT_TYPES: PROMPTS[prompts]},
                         range(6))
    (items, _), _ = batch
    assert items["embeddings"].shape[1] == 1 + ways * shots


@pytest.mark.parametrize("fold", [0, 3])
@pytest.mark.parametrize("shots", [1, 5])
def test_pascal5i_train_episodes_match_jax(voc_root, fold, shots):
    """The training split (the example generator's draws) at 1 and 5
    shots and 1 and 2 ways, the prompt type drawn at the episode level, as
    ``trainval/pascal/mae.yaml`` sets it."""
    jset, tset = _pair(voc_root, "pascal5i",
                       dict(name="pascal", split="train", val_fold_idx=fold,
                            n_folds=4, sample_function="uniform",
                            all_example_categories=False),
                       dict(remove_small_annotations=shots == 5,
                            do_subsample=False, custom_preprocess=False))
    combos = [["mask"], ["point"], ["bbox"], ["mask", "point"]]
    for ways in (1, 2):
        _check_items(jset, tset,
                     {K.NUM_EXAMPLES: shots, K.NUM_CLASSES: ways,
                      K.PROMPT_TYPES: combos,
                      K.PROMPT_CHOICE_LEVEL: "episode"}, range(4))


@pytest.mark.parametrize("split", ["train", "val"])
def test_pascal_dataset_episodes_match_jax(voc_root, split):
    """``PascalDataset`` (all 20 classes) with subsampling and every
    example's categories, all prompt types in one episode."""
    jset, tset = _pair(voc_root, "pascal",
                       dict(split=split, sample_function="power_law"),
                       dict(do_subsample=True))
    _check_items(jset, tset, {K.NUM_EXAMPLES: 2,
                              K.PROMPT_TYPES: PROMPTS["all"]}, range(5))


def test_pascal_caches_and_gt_match_jax(voc_root, tmp_path):
    """The caches' ``embedding`` and ``{name}_gt`` as the JAX package reads
    them (``safetensors.numpy``); without caches both read ``JPEGImages``
    (written here by PIL at the masks' sizes): the port's uint8 frames,
    normalized as the model normalizes them, equal the JAX package's
    host-normalized ones bit for bit."""
    jset, tset = _pair(voc_root, "pascal", dict(split="val"),
                       dict(load_gts=True))
    tp, jp = tset.datasets["pascal"], jset.datasets["pascal"]
    names = tp.image_names[:3]
    emb_dir = tmp_path / "caches"
    emb_dir.mkdir()
    for n in names:
        f = load_file(f"{voc_root['emb_dir']}/{n}.safetensors")
        gt = np.asarray(Image.open(
            f"{voc_root['data_dir']}/SegmentationClass/{n}.png"), np.int32)
        save_file({"embedding": f["embedding"].numpy(), "pascal_gt": gt},
                  str(emb_dir / f"{n}.safetensors"))
    tp.emb_dir = jp.emb_dir = str(emb_dir)
    emb, key, gts = tp._get_images_or_embeddings(names)
    jemb, jkey, jgts = jp._get_images_or_embeddings(names)
    assert key == jkey and emb.dtype == jemb.dtype
    np.testing.assert_array_equal(emb, jemb)
    for g, jg in zip(gts, jgts):
        np.testing.assert_array_equal(g, jg)
    rng = np.random.default_rng(0)
    os.makedirs(f"{voc_root['data_dir']}/JPEGImages", exist_ok=True)
    for n in names:
        h, w = tp._get_seg(n).shape
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            f"{voc_root['data_dir']}/JPEGImages/{n}.jpg", quality=80)
    tp.load_embeddings = jp.load_embeddings = False
    images, key, _ = tp._get_images_or_embeddings(names)
    jimages, jkey, _ = jp._get_images_or_embeddings(names)
    assert key == jkey == "images" and images.dtype == np.uint8
    for frame, jframe, n in zip(images, jimages, names):
        nh, nw = get_preprocess_shape(*tp._get_seg(n).shape, tp.image_size)
        np.testing.assert_array_equal(
            normalize_padded(frame[:nh, :nw], tp.image_size), jframe)


def _mae_engine(voc_root):
    """``trainval/pascal/mae.yaml``'s datasets and dataloader (first grid
    point) on the synthetic root at a 64-pixel frame."""
    cfg = expand_experiment(load_yaml(
        str(REPO / "parameters/trainval/pascal/mae.yaml")))[0]
    datasets = {k: {**v, **voc_root}
                for k, v in cfg["dataset"]["datasets"].items()}
    for k, v in datasets.items():
        if k.startswith("val_"):
            v["val_num_samples"] = 8
    common = dict(cfg["dataset"]["common"], image_size=IMAGE_SIZE)
    return datasets, common, cfg["dataloader"]


@pytest.mark.parametrize("name", ["pascal5i", "val_pascal5i_N2K1"])
def test_pascal_engine_batches_match_jax(voc_root, name):
    """The first batches of ``trainval/pascal/mae.yaml``'s sets through
    dataset + sampler + thread loader, as ``Run`` builds them."""
    datasets, common, dl = _mae_engine(voc_root)
    out = []
    for ds_mod, loader_mod in ((jds, jloader), (tds, tloader)):
        dataset = ds_mod.LabelAnythingDataset({name: datasets[name]}, common)
        cls = (JaxSamplerEpisodeTypesWhole if ds_mod is jds
               else ds_mod.VariableBatchSampler)
        if name == "pascal5i":
            sampler = cls(dataset, dl["possible_batch_example_nums"],
                          prompt_types=dl["prompt_types"],
                          prompt_choice_level=dl["prompt_choice_level"][0],
                          shuffle=True, seed=42, num_steps=4)
        else:
            sampler = cls(dataset, dl["val_possible_batch_example_nums"],
                          prompt_types=dl["val_prompt_types"], seed=42)
        if ds_mod is jds:
            dataset.reseed(42)    # the JAX thread loader leaves it unseeded
        loader = loader_mod.EpisodeLoader(dataset, sampler, num_workers=2,
                                          seed=42)
        try:
            out.append(list(loader))
        finally:
            loader.close()
    assert len(out[1]) >= 1
    assert_batches_equal(out[1], out[0])


def test_validation_pascal_configs_raise_on_both_sides():
    """``parameters/validation/Pascal/mae.yaml`` gives the reference's
    ``instances_path`` / ``img_dir`` and no ``data_dir``: the JAX
    ``PascalDataset`` joins None into a path (TypeError), the port names
    the missing key (ROADMAP C12)."""
    cfg = expand_experiment(load_yaml(
        str(REPO / "parameters/validation/Pascal/mae.yaml")))[0]
    name, params = next(iter(cfg["dataset"]["datasets"].items()))
    assert "data_dir" not in params and "instances_path" in params
    common = cfg["dataset"]["common"]
    with pytest.raises(TypeError):
        jds.LabelAnythingDataset({name: params}, common)
    with pytest.raises(ValueError, match="data_dir"):
        tds.LabelAnythingDataset({name: params}, common)


def test_pascal_categories_and_folds_match_jax():
    assert tpascal.PASCAL_CATEGORIES == jpascal.PASCAL_CATEGORIES
    assert tpascal.PASCAL_IGNORE == jpascal.PASCAL_IGNORE


C14_DRAWS = """
import json
import numpy as np
from labelanything_tpu.data.examples import uniform_sampling as jax_draw
from labelanything_tpu_torch.data.examples import uniform_sampling as port_draw
names = {f"2008_{i:06d}" for i in range(64)}
ids = {3 * i for i in range(64)}
print(json.dumps([[draw(pool, ["2008_000007", 9], np.random.default_rng(s))
                   for s in range(8)]
                  for draw in (jax_draw, port_draw) for pool in (names, ids)]))
"""


def test_c14_name_draws_follow_the_hash_seed_in_jax_only():
    """ROADMAP C14: a draw from a set of VOC image names follows Python's
    string hash seed in the JAX package, so two processes draw other
    PASCAL training episodes from one seed; the port draws the same names
    under any hash seed. A draw from a set of ints (COCO's ids) is the
    same in both packages and under any hash seed."""
    runs = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO))
        out = subprocess.run([sys.executable, "-c", C14_DRAWS], env=env,
                             capture_output=True, text=True, check=True)
        runs.append(json.loads(out.stdout))
    (jax_names, jax_ids, port_names, port_ids) = zip(*runs)
    assert jax_names[0] != jax_names[1]
    assert port_names[0] == port_names[1]
    assert jax_ids[0] == jax_ids[1] == port_ids[0] == port_ids[1]
    assert "2008_000007" not in port_names[0] and 9 not in port_ids[0]
