"""YAML grid-search configuration (counterpart of
``labelanything_tpu/utils/config.py``; reference:
label_anything/utils/grid.py and experiment/experiment.py:43-175).

The files are read by ``utils/yaml_subset.py``, which gives what
``yaml.safe_load`` gives on the subset of YAML they use; the grid helpers
are the JAX module's.

A parameter file is a nested dict whose every leaf is a *list* of candidate
values; ``make_grid`` expands the cartesian product into run configs.
``other_grids`` entries are nested-dict overrides producing additional grids.
"""

from __future__ import annotations

import collections.abc
import itertools
from typing import Any, Dict, List, Mapping, Tuple

from . import yaml_subset


def load_yaml(path: str) -> dict:
    return yaml_subset.load(path)


def linearize(dictionary: Mapping) -> List[Tuple[Any, list]]:
    """(reference: utils/grid.py:7-27)."""
    exps: List[Tuple[Any, list]] = []
    for key, value in dictionary.items():
        if isinstance(value, collections.abc.Mapping):
            exps.extend(
                ((key, lin_key), lin_value) for lin_key, lin_value in linearize(value)
            )
        elif isinstance(value, list):
            exps.append((key, value))
        elif value is None:
            exps.append((key, [{}]))
        else:
            raise ValueError(
                f"Grid leaves must be dict, list or None; got {type(value)} at {key}"
            )
    return exps


def _extract(elem: tuple):
    return elem[0] if len(elem) == 1 else elem


def delinearize(lin_dict: Dict) -> Dict:
    """(reference: utils/grid.py:49-69)."""
    filtered = sorted(
        (item for item in lin_dict.items() if isinstance(item[0], tuple)),
        key=lambda x: str(x[0][0]),
    )
    grouped = itertools.groupby(filtered, lambda x: x[0][0])
    new_dict = {
        k: delinearize({_extract(elem[0][1:]): elem[1] for elem in v})
        for k, v in grouped
    }
    base = {k: v for k, v in lin_dict.items() if not isinstance(k, tuple)}
    return {**base, **new_dict}


def make_grid(dict_of_list: Mapping, return_cartesian_elements: bool = False):
    """(reference: utils/grid.py:72-93)."""
    linearized = linearize(dict_of_list)
    keys, values = zip(*linearized) if linearized else ((), ())
    if any(len(v) == 0 for v in values):
        raise ValueError("There shouldn't be empty lists in grid!")
    grid = [
        delinearize(dict(zip(keys, combo)))
        for combo in itertools.product(*values)
    ]
    if return_cartesian_elements:
        ce = [item for item in linearized if len(item[1]) > 1]
        return grid, ce
    return grid


def deep_update(base: dict, override: Mapping) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, collections.abc.Mapping) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = v
    return out


def expand_experiment(config: dict) -> List[dict]:
    """Expand a full experiment file (with optional ``other_grids``) into the
    flat list of run configs (reference: experiment/experiment.py:156-175)."""
    config = dict(config)
    other_grids = config.pop("other_grids", None) or []
    base = config.pop("parameters", config)
    runs = make_grid(base)
    for override in other_grids:
        merged = deep_update(base, override)
        runs.extend(make_grid(merged))
    return runs
