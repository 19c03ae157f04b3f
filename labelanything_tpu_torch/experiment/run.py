"""Training and validation of one grid configuration (counterpart of
``labelanything_tpu/experiment/run.py``; reference:
label_anything/experiment/run.py).

``Run().init(params, run_dir, device)`` builds the episode loaders, the
model (on ``device``: the first CUDA card unless the caller names another,
such as ``"cpu"``), the loss, the optimizer and its schedule, and resumes
from ``<run_dir>/checkpoints/latest`` when there is one; ``launch()``
trains ``max_epochs`` epochs, validating every ``val_frequency`` and saving
``latest`` and ``best``.

Each batch of the sampler, in its order, goes through the substitution
passes of :class:`..train.substitutor.Substitutor`, one eager call of the
train step per pass. The JAX package stacks same-shape batches into one
``lax.scan`` dispatch (``train_params.chunk_steps``); that is how the TPU
is fed, not what is computed, and ``chunk_steps`` has no effect here.

Metrics follow the reference's protocol: each pass's per-sample episode
confusion matrices are folded on the device into one global matrix through
the batch's episode-to-global class table (reference: data/utils.py:568-589),
and the host fetches the matrices, the loss sums and the NaN sentinel
after each batch in which the pass count crosses a multiple of
``log_frequency`` (as the JAX loop logs), so that the steps themselves add
no synchronization. ``test()`` runs the test protocol of the ``test_*``
datasets: class embeddings of one support batch, then the queries in
chunks. Images are not logged (``utils/visualize.py`` needs PIL and
is not ported): a configured ``train_image_log_frequency`` /
``val_image_log_frequency`` is reported once as skipped.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..api import build_on_device
from ..data.dataset import (LabelAnythingDataset, VariableBatchSampler,
                            test_registry)
from ..data.loader import EpisodeLoader
from ..parallel.train_step import TrainState, init_train_state, make_train_step
from ..train.checkpoint import CheckpointManager
from ..train.losses import LabelAnythingLoss
from ..train.metrics import (binary_confusion_matrix,
                             confusion_matrix_per_sample,
                             fold_confusion_global, fb_iou_np, mean_iou_np,
                             strict_mean_iou_np, to_global_lut)
from ..train.substitutor import Substitutor, divide_query_examples
from ..typing import IGNORE_INDEX, BatchKeys, ResultDict
from ..utils.logging import ExperimentLogger, get_logger

logger = get_logger(__name__)

_HOST_KEYS = (BatchKeys.CLASSES, BatchKeys.IMAGE_IDS, BatchKeys.INTENDED_CLASSES)

# (all-zero flag key) -> keys removed when that prompt modality is absent
_MODALITY_KEYS = (
    (BatchKeys.FLAG_POINTS, (BatchKeys.PROMPT_POINTS, BatchKeys.FLAG_POINTS)),
    (BatchKeys.FLAG_BBOXES, (BatchKeys.PROMPT_BBOXES, BatchKeys.FLAG_BBOXES)),
    (BatchKeys.FLAG_MASKS, (BatchKeys.PROMPT_MASKS, BatchKeys.FLAG_MASKS)),
)


def drop_absent_modalities(batch: Dict[str, Any],
                           example_rows: Optional[slice] = None
                           ) -> Dict[str, Any]:
    """Drop a prompt modality whose flags are all zero, as the reference's
    ``Lam.prepare_prompts`` does (lam.py:215-239): absence changes the sparse
    token layout downstream. Checked on the host's numpy flags;
    ``example_rows`` restricts the check to the prompt rows (validation's
    single pass uses rows ``1..N``). When every modality would go, the batch
    is returned unchanged."""
    absent = []
    present = 0
    for flag_key, keys in _MODALITY_KEYS:
        flags = batch.get(flag_key)
        if flags is None:
            continue
        f = np.asarray(flags)
        if example_rows is not None:
            f = f[:, example_rows]
        if (f == 0).all():
            absent.append(keys)
        else:
            present += 1
    if not absent or present == 0:
        return batch
    out = dict(batch)
    for keys in absent:
        for k in keys:
            out.pop(k, None)
    return out


def with_all_modalities(input_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Re-add zero prompts of every dropped modality (a batch that reaches
    every branch of the prompt encoder)."""
    out = dict(input_dict)
    flags = out[BatchKeys.FLAG_EXAMPLES]
    b, m, c = flags.shape
    zeros = lambda *shape, dtype: torch.zeros(shape, dtype=dtype,
                                              device=flags.device)
    if BatchKeys.PROMPT_POINTS not in out:
        out[BatchKeys.PROMPT_POINTS] = zeros(b, m, c, 1, 2, dtype=torch.float32)
        out[BatchKeys.FLAG_POINTS] = zeros(b, m, c, 1, dtype=torch.int32)
    if BatchKeys.PROMPT_BBOXES not in out:
        out[BatchKeys.PROMPT_BBOXES] = zeros(b, m, c, 1, 4, dtype=torch.float32)
        out[BatchKeys.FLAG_BBOXES] = zeros(b, m, c, 1, dtype=torch.int32)
    if BatchKeys.PROMPT_MASKS not in out:
        # two stride-2 convs in mask_downscaling: H, W divisible by 4
        out[BatchKeys.PROMPT_MASKS] = zeros(b, m, c, 8, 8, dtype=torch.float32)
        out[BatchKeys.FLAG_MASKS] = zeros(b, m, c, dtype=torch.int32)
    return out


def _first(x):
    if isinstance(x, (list, tuple)):
        return x[0]
    return x


def _norm_scheduler(sched):
    """Reference scheduler configs use 'type'; ``build_optimizer`` wants
    'name'."""
    if not sched:
        return None
    sched = dict(sched)
    if "type" in sched:
        sched["name"] = sched.pop("type")
    sched.pop("step_moment", None)
    return sched


class Run:
    """(reference: experiment/run.py:68-849)."""

    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.state: Optional[TrainState] = None
        self.global_train_step = 0
        self.start_epoch = 0
        # per training batch of the last epoch: (clock when the loop asked
        # the loader for it, seconds it waited, episodes)
        self.batch_times: List[tuple] = []
        # per validation batch of a set's last pass: (clock when the loop
        # asked the loader for it, seconds it waited, seconds in the loop,
        # episodes)
        self.val_batch_times: Dict[str, List[tuple]] = {}
        # per test dataset: the support set's and the queries' seconds
        self.test_times: Dict[str, Dict[str, float]] = {}
        # per validation / test set: the host copies of its last pass's
        # confusion matrices (classes, then background / foreground)
        self.confusions: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    # ------------------------------------------------------------------ #

    def init(self, params: Dict[str, Any], run_dir: str = "runs/run0",
             device: Union[str, torch.device] = "cuda") -> "Run":
        self.params = dict(params)
        self.device = torch.device(device)
        self.seed = params.get("seed", 42)
        self.train_params = params.get("train_params", {})
        self.model_params = dict(params.get("model", {}))
        self.dataset_params = params.get("dataset", {})
        self.dataloader_params = dict(params.get("dataloader", {}))
        logger_params = params.get("logger", {})

        self.tracker = ExperimentLogger(run_dir, name=params.get("name", "run"))
        self.checkpoints = CheckpointManager(
            f"{run_dir}/checkpoints",
            watch_metric=self.train_params.get("watch_metric", "miou"),
        )
        self.log_frequency = logger_params.get("log_frequency", 10)
        self.image_log_frequency = logger_params.get(
            "train_image_log_frequency", 0)
        self.val_image_log_frequency = logger_params.get(
            "val_image_log_frequency", 0)
        self._images_skipped_logged = False
        self.run_dir = run_dir

        self._build_dataloaders()

        # the model's unpad semantics must match the dataset's resize: the
        # reference forwards the flag (experiment/run.py:147-151)
        config = dict(self.model_params)
        if "custom_preprocess" not in config:
            config["custom_preprocess"] = (
                self.dataset_params.get("common", {})
                .get("custom_preprocess", True))
        loss_params = dict(self.train_params.get("loss", {}))
        loss = LabelAnythingLoss(
            components=loss_params.get("components", {"focal": {"weight": 1.0}}),
            class_weighting=loss_params.get("class_weighting", False),
        )
        model = build_on_device(config, self.device, self.seed)
        self._build_state(model, loss)
        return self

    def _build_dataloaders(self):
        datasets_params = dict(self.dataset_params.get("datasets", {}))
        common = dict(self.dataset_params.get("common", {}))
        dl = self.dataloader_params
        num_workers = dl.get("num_workers", 8)
        use_processes = _first(dl.get("use_processes", False))

        val_params = {k: v for k, v in datasets_params.items()
                      if k.startswith("val_")}
        test_params = {k: v for k, v in datasets_params.items()
                       if k.startswith("test_")}
        train_params = {k: v for k, v in datasets_params.items()
                        if k not in val_params and k not in test_params}

        self.train_loader = None
        if train_params:
            dataset = LabelAnythingDataset(train_params, common)
            sampler = VariableBatchSampler(
                dataset,
                possible_batch_example_nums=dl["possible_batch_example_nums"],
                prompt_types=dl.get("prompt_types"),
                prompt_choice_level=_first(dl.get("prompt_choice_level", "batch")),
                shuffle=True,
                num_steps=dl.get("num_steps"),
                seed=self.seed,
            )
            self.train_loader = EpisodeLoader(
                dataset, sampler, num_workers, use_processes=use_processes,
                seed=self.seed)
            self.train_dataset = dataset

        self.test_params = test_params
        self.val_loaders = {}
        for name, p in val_params.items():
            dataset = LabelAnythingDataset({name: p}, common)
            sampler = VariableBatchSampler(
                dataset,
                possible_batch_example_nums=dl.get(
                    "val_possible_batch_example_nums",
                    dl["possible_batch_example_nums"]),
                prompt_types=dl.get("val_prompt_types", dl.get("prompt_types")),
                seed=self.seed,
            )
            self.val_loaders[name] = EpisodeLoader(
                dataset, sampler, num_workers, use_processes=use_processes,
                seed=self.seed)

    def _build_state(self, model: torch.nn.Module, loss: torch.nn.Module):
        tp = self.train_params
        sched_cfg = tp.get("scheduler")
        if isinstance(sched_cfg, list):
            sched_cfg = sched_cfg[0]
        step_moment = (sched_cfg or {}).get("step_moment", "batch")
        schedule_div = 1
        if step_moment == "epoch" and self.train_loader is not None:
            # the reference steps its scheduler once per epoch here
            # (experiment/utils.py:77-100): divide by the updates an epoch
            # makes
            schedule_div = self.train_loader.updates_per_epoch(
                substitute=tp.get("substitute", True),
                accumulate=tp.get("accumulate_substitution", False))
        self.state = init_train_state(
            model, loss, self.device, dropout_seed=self.seed,
            name=tp.get("optimizer", "AdamW"),
            learning_rate=tp.get("initial_lr", 5e-5),
            weight_decay=tp.get("weight_decay", 0.0),
            momentum=tp.get("momentum", 0.9),
            backbone_lr=tp.get("backbone_lr"),
            freeze_backbone=tp.get("freeze_backbone", False),
            scheduler=_norm_scheduler(sched_cfg),
            schedule_div=schedule_div,
        )
        self.train_step = make_train_step(with_confmat=True)
        # the class-row draws of RandomMatrixEncoder, reseeded every epoch
        self.generator = torch.Generator()
        restored, meta = self.checkpoints.restore(self.state, "latest",
                                                  self.generator)
        if restored is not None:
            self.state = restored
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            logger.info("resumed from epoch %d", self.start_epoch)
        else:
            self.start_epoch = 0

    # ------------------------------------------------------------------ #

    def launch(self):
        max_epochs = self.train_params.get("max_epochs", 1)
        best = None
        val_frequency = int(self.train_params.get("val_frequency", 1) or 1)
        watch = self.train_params.get("watch_metric", "miou")
        for epoch in range(self.start_epoch, max_epochs):
            self.train_epoch(epoch)
            # validate every val_frequency epochs (reference: run.py:284)
            metrics = (self.validate(epoch)
                       if epoch % val_frequency == 0 else {})
            value = metrics.get(watch, metrics.get("miou", 0.0))
            self.checkpoints.save_latest(self.state, epoch, self.generator)
            self.tracker.log_training_state(
                "latest", epoch, f"{self.run_dir}/checkpoints/latest")
            if self.checkpoints.maybe_save_best(self.state, epoch, value,
                                                self.generator):
                best = value
                self.tracker.log_training_state(
                    "best", epoch, f"{self.run_dir}/checkpoints/best",
                    metric=watch, value=value)
                logger.info("new best %s=%.4f @ epoch %d", watch, value, epoch)
        self.close()
        return best

    def close(self):
        """Release the loaders' worker pools and the metric file."""
        for loader in [self.train_loader, *self.val_loaders.values()]:
            if loader is not None:
                loader.close()
        self.tracker.close()

    def _skip_images(self):
        if not self._images_skipped_logged:
            self._images_skipped_logged = True
            logger.info("image logging skipped: utils/visualize.py is not "
                        "ported (ROADMAP A11)")

    def _device_batch(self, batch, example_rows: Optional[slice] = None):
        """(tensors on the run's device, host metadata) of a collated
        batch. The copies do not wait for the card: the loader's numpy
        buffers are staged at once and are not reused."""
        batch = drop_absent_modalities(batch, example_rows=example_rows)
        device = {}
        for k, v in batch.items():
            if k in _HOST_KEYS or v is None:
                continue
            if isinstance(v, dict):   # pyramid caches, one array a stage
                device[k] = {s: torch.from_numpy(np.asarray(a)).to(
                    self.device, non_blocking=True) for s, a in v.items()}
            else:
                device[k] = torch.from_numpy(np.asarray(v)).to(
                    self.device, non_blocking=True)
        host = {k: batch.get(k) for k in _HOST_KEYS}
        return device, host

    def _lut(self, host, device_batch, categories) -> torch.Tensor:
        lut = to_global_lut(host[BatchKeys.CLASSES], categories,
                            int(device_batch[BatchKeys.FLAG_EXAMPLES].shape[2]))
        return torch.from_numpy(lut).to(self.device, non_blocking=True)

    # ------------------------------------------------------------------ #

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch over the train loader. The metric window (global and
        binary confusion matrices, loss sum and last loss, the index of the
        first non-finite loss) lives on the device and is fetched every
        ``log_frequency`` passes, at the end of a batch, as the JAX loop
        logs; with ``check_nan`` a non-finite loss then
        dumps the batch it came from and the parameters to
        ``<run_dir>/nan_dump.pt`` and raises (reference: check_nan,
        experiment/utils.py:139-157), up to ``log_frequency`` passes late."""
        assert self.train_loader is not None, "no train datasets configured"
        tp = self.train_params
        accumulate = tp.get("accumulate_substitution", False)
        substitute = tp.get("substitute", True)
        num_points = tp.get("num_points", 1)
        check_nan = tp.get("check_nan", 0)
        if self.image_log_frequency:
            self._skip_images()

        self.train_loader.set_epoch(epoch)
        self.generator.manual_seed(self.seed * 100003 + epoch)
        categories = next(iter(self.train_dataset.datasets.values())).categories
        num_global = len(categories) + 1
        dev = self.device
        cm = np.zeros((num_global, num_global), np.int64)
        cm2 = np.zeros((2, 2), np.int64)
        loss_sum, loss_count = 0.0, 0
        last_loss = float("nan")

        def fresh_window():
            return {"cm": torch.zeros((num_global, num_global),
                                      dtype=torch.long, device=dev),
                    "cm2": torch.zeros((2, 2), dtype=torch.long, device=dev),
                    "loss_sum": torch.zeros((), device=dev),
                    "loss_last": torch.zeros((), device=dev),
                    "first_bad": torch.full((), -1, dtype=torch.long,
                                            device=dev)}

        window = fresh_window()
        window_batches: List[list] = []   # [host batch, passes] in order
        window_count = 0

        def flush():
            nonlocal window, window_count, cm, cm2, loss_sum, loss_count
            nonlocal last_loss
            if not window_count:
                return
            m = {k: v.cpu().numpy() for k, v in window.items()}
            cm += m["cm"]
            cm2 += m["cm2"]
            loss_sum += float(m["loss_sum"])
            loss_count += window_count
            last_loss = float(m["loss_last"])
            first_bad = int(m["first_bad"])
            if check_nan and first_bad >= 0:
                acc, bad_batch = 0, window_batches[-1][0]
                for hb, n in window_batches:
                    if first_bad < acc + n:
                        bad_batch = hb
                        break
                    acc += n
                self._nan_dump(bad_batch, first_bad)
            with self.tracker.phase("train"):
                self.tracker.log_metrics(
                    {"loss": last_loss,
                     "mIoU": strict_mean_iou_np(cm),
                     "FBIoU": fb_iou_np(cm2)},
                    step=self.global_train_step, epoch=epoch)
            window = fresh_window()
            window_batches.clear()
            window_count = 0

        self.batch_times = []
        t0 = time.perf_counter()
        loader = iter(self.train_loader)
        while True:
            t_wait = time.perf_counter()
            try:
                (batch, gts), _names = next(loader)
            except StopIteration:
                break
            t_got = time.perf_counter()
            device_batch, host = self._device_batch(batch)
            n_passes = gts.shape[1] + 1 if substitute else 1
            loss_scale = 1.0 / n_passes if accumulate else 1.0
            lut = self._lut(host, device_batch, categories)
            sub = Substitutor(num_points=num_points, substitute=substitute,
                              generator=self.generator)
            sub.reset(device_batch)
            for i, (input_dict, gt) in enumerate(sub):
                self.state, aux = self.train_step(
                    self.state, input_dict, gt, self.generator, loss_scale,
                    apply_update=(not accumulate) or i == n_passes - 1,
                    use_accum=accumulate and n_passes > 1)
                loss = aux["loss"]
                window["cm"] += fold_confusion_global(aux["confmat_ps"], lut,
                                                      num_global)
                window["cm2"] += aux["confmat2"]
                window["loss_sum"] += loss
                window["loss_last"] = loss
                bad = ~torch.isfinite(loss)
                window["first_bad"] = torch.where(
                    (window["first_bad"] < 0) & bad,
                    torch.full_like(window["first_bad"], window_count),
                    window["first_bad"])
                window_count += 1
                if window_batches and window_batches[-1][0] is batch:
                    window_batches[-1][1] += 1
                else:
                    window_batches.append([batch, 1])
                sub.generate_new_points(aux["preds"], gt,
                                        aux["confmat_ps"].shape[1])
            before = self.global_train_step
            self.global_train_step += n_passes
            if (self.global_train_step // self.log_frequency
                    > before // self.log_frequency):
                flush()
            self.batch_times.append((t_wait, t_got - t_wait,
                                     int(gts.shape[0])))
        flush()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        seconds = t_end - t0
        wait = sum(t[1] for t in self.batch_times)
        # the rate after two warm-up batches (first calls, allocator growth)
        late = self.batch_times[2:]
        rate = (sum(t[2] for t in late) / (t_end - late[0][0]) if late
                else float("nan"))
        metrics = {
            "loss": loss_sum / max(loss_count, 1),
            "miou": strict_mean_iou_np(cm),
            "fbiou": fb_iou_np(cm2),
            "epoch_time": seconds,
            "loader_wait_share": wait / max(seconds, 1e-9),
            "episodes_per_s": rate,
        }
        with self.tracker.phase("train"):
            self.tracker.log_metrics({f"avg_{k}": v for k, v in metrics.items()},
                                     epoch=epoch)
        logger.info("epoch %d train: %s", epoch,
                    {k: round(v, 4) for k, v in metrics.items()})
        return metrics

    def _nan_dump(self, batch, first_bad: int):
        path = f"{self.run_dir}/nan_dump.pt"
        try:
            torch.save({"batch": {k: v for k, v in batch.items()
                                  if isinstance(v, np.ndarray)},
                        "params": {k: v.detach().cpu() for k, v in
                                   self.state.model.state_dict().items()},
                        "window_pass": first_bad}, path)
            logger.error("non-finite loss; batch dumped to %s", path)
        except Exception as exc:
            logger.error("non-finite loss (dump failed: %s)", exc)
        raise FloatingPointError(f"non-finite loss at pass {first_bad} of "
                                 "the last metric window")

    # ------------------------------------------------------------------ #

    def validate(self, epoch: int) -> Dict[str, float]:
        if not self.val_loaders:
            return {}
        reruns = self.params.get("val_params", {}).get("reruns", 1)
        results = {}
        for name, loader in self.val_loaders.items():
            per_run = []
            for run_idx in range(reruns):
                # reference protocol: seed = base + run (run.py:618-641)
                loader.batch_sampler.reseed(self.seed + run_idx)
                loader.reseed(self.seed + run_idx)
                per_run.append(self._validate_one(loader, name, epoch=epoch))
            agg = {k: float(np.mean([r[k] for r in per_run]))
                   for k in per_run[0]}
            results.update({f"{name}_{k}": v for k, v in agg.items()})
            with self.tracker.phase(f"validate/{name}"):
                self.tracker.log_metrics(agg, epoch=epoch)
            logger.info("epoch %d val %s: %s", epoch, name,
                        {k: round(v, 4) for k, v in agg.items()})
        mious = [v for k, v in results.items() if k.endswith("_miou")]
        if mious:
            results["miou"] = float(np.mean(mious))
        return results

    @torch.no_grad()
    def _validate_one(self, loader: EpisodeLoader, name: str,
                      epoch: Optional[int] = None) -> Dict[str, float]:
        """One pass over a validation loader: the query's prediction from
        the examples' prompts, in ``eval()`` mode; the matrices stay on the
        device until the end."""
        if self.val_image_log_frequency:
            self._skip_images()
        dataset = loader.dataset
        categories = next(iter(dataset.datasets.values())).categories
        num_global = len(categories) + 1
        dev = self.device
        cm = torch.zeros((num_global, num_global), dtype=torch.long, device=dev)
        cm2 = torch.zeros((2, 2), dtype=torch.long, device=dev)
        model = self.state.model
        model.eval()
        times = self.val_batch_times[name] = []
        batches = iter(loader)
        while True:
            t_wait = time.perf_counter()
            try:
                (batch, _gts), _ = next(batches)
            except StopIteration:
                break
            t_got = time.perf_counter()
            device_batch, host = self._device_batch(
                batch, example_rows=slice(1, None))
            lut = self._lut(host, device_batch, categories)
            input_dict, gt = divide_query_examples(device_batch)
            logits = model(input_dict)[ResultDict.LOGITS]
            preds = logits.argmax(dim=1)
            cm += fold_confusion_global(
                confusion_matrix_per_sample(preds, gt, logits.shape[1]),
                lut, num_global)
            cm2 += binary_confusion_matrix(preds, gt)
            times.append((t_wait, t_got - t_wait,
                          time.perf_counter() - t_wait, int(gt.shape[0])))
        cm, cm2 = cm.cpu().numpy(), cm2.cpu().numpy()
        self.confusions[name] = (cm, cm2)
        # the reference's validate_run triple (run.py:735-742)
        return {
            "miou": strict_mean_iou_np(cm),
            "fbiou": fb_iou_np(cm2),
            "bmiou": mean_iou_np(cm),
        }

    # ------------------------------------------------------------------ #
    # the test protocol (reference: run.py:744-843)
    # ------------------------------------------------------------------ #

    def test(self, batch_size: int = 8) -> Dict[str, float]:
        """Support prompts -> class embeddings -> ``predict`` a query
        chunk at a time, for every ``test_*`` dataset (built from its own
        parameters, without ``common``, as the JAX ``Run.test`` does)."""
        registry = test_registry()
        assert self.test_params, "no test datasets configured"
        results: Dict[str, float] = {}
        for name, p in self.test_params.items():
            key = name if name in registry else "_".join(name.split("_")[:2])
            dataset = registry[key](**p)
            results.update({f"{name}_{k}": v for k, v in self._test_one(
                dataset, name, batch_size).items()})
        return results

    @torch.no_grad()
    def _test_one(self, dataset, name: str, batch_size: int
                  ) -> Dict[str, float]:
        """One test set: ``generate_class_embeddings`` once on the support
        batch, then ``predict`` over chunks of ``batch_size`` queries (the
        last padded with its own last item, ``row_valid`` zeroing the pad
        rows). The confusion matrices over the dataset's ``num_classes``
        classes are folded on the device and fetched every 8 chunks; the
        host reads no prediction."""
        dev = self.device
        model = self.state.model
        model.eval()
        to_device = lambda v: torch.from_numpy(np.asarray(v)).to(
            dev, non_blocking=True)
        sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
                else (lambda: None))
        t0 = time.perf_counter()
        support = drop_absent_modalities(dataset.extract_prompts())
        class_embs = model.generate_class_embeddings(
            {k: to_device(v) for k, v in support.items()})
        sync()
        t_support = time.perf_counter() - t0

        c = dataset.num_classes
        cm = np.zeros((c, c), np.int64)
        cm2 = np.zeros((2, 2), np.int64)
        window = None

        def fetch():
            nonlocal window
            if window is not None:
                cm[:] += window[0].cpu().numpy()
                cm2[:] += window[1].cpu().numpy()
            window = None

        def chunks():
            chunk = []
            for i in range(len(dataset)):
                chunk.append(dataset[i])
                if len(chunk) == batch_size:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        t1 = time.perf_counter()
        queries = 0
        for count, chunk in enumerate(chunks(), 1):
            n = len(chunk)
            batch, gt = dataset.collate_fn(chunk + [chunk[-1]] * (batch_size - n))
            batch = {k: to_device(v) for k, v in batch.items()}
            gt = to_device(gt)
            w = (torch.arange(batch_size, device=dev) < n).long()[:, None, None]
            preds = model.predict(batch, class_embs).argmax(dim=1)
            part = (confusion_matrix_per_sample(preds, gt, c) * w).sum(dim=0)
            fg = torch.where(gt == IGNORE_INDEX, IGNORE_INDEX,
                             (gt > 0).long())
            part2 = (confusion_matrix_per_sample(
                (preds > 0).long(), fg, 2) * w).sum(dim=0)
            window = ((part, part2) if window is None
                      else (window[0] + part, window[1] + part2))
            queries += n
            if count % 8 == 0:
                fetch()
        fetch()
        self.test_times[name] = {"support_s": t_support,
                                 "queries_s": time.perf_counter() - t1,
                                 "queries": queries}
        self.confusions[name] = (cm, cm2)
        metrics = {"miou": strict_mean_iou_np(cm), "fbiou": fb_iou_np(cm2)}
        with self.tracker.phase(f"test/{name}"):
            self.tracker.log_metrics(metrics)
        logger.info("test %s: %s", name,
                    {k: round(v, 4) for k, v in metrics.items()})
        return metrics
