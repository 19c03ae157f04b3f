"""The port's YAML reader and grid expansion against PyYAML and the JAX
package: on every file under ``parameters/``, ``utils/yaml_subset.load``
gives what ``yaml.safe_load`` gives (types, key order and values alike),
``utils/config.expand_experiment`` gives the JAX ``expand_experiment``'s
run list, and ``yaml_subset.dumps`` writes text both read back the same;
text outside the subset raises."""

import math
import pathlib

import pytest
import yaml

from labelanything_tpu.utils import config as jconfig
from labelanything_tpu_torch.utils import config, yaml_subset
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMETER_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "parameters").rglob("*.yaml"))


def same(a, b, path="$"):
    """None when ``a`` and ``b`` are equal with the same types all the way
    down and the same key order, else where they differ."""
    if type(a) is not type(b):
        return f"{path}: {type(a).__name__} {a!r} vs {type(b).__name__} {b!r}"
    if isinstance(a, dict):
        if list(a) != list(b):
            return f"{path}: keys {list(a)} vs {list(b)}"
        for k in a:
            diff = same(a[k], b[k], f"{path}.{k}")
            if diff:
                return diff
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return f"{path}: length {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            diff = same(x, y, f"{path}[{i}]")
            if diff:
                return diff
        return None
    if isinstance(a, float) and math.isnan(a) and math.isnan(b):
        return None
    return None if a == b else f"{path}: {a!r} vs {b!r}"


def test_there_are_a_hundred_parameter_files():
    assert len(PARAMETER_FILES) == 100


@pytest.mark.parametrize("path", PARAMETER_FILES)
def test_parameter_file_matches_pyyaml_and_jax(path):
    full = REPO / path
    with open(full) as f:
        expected = yaml.safe_load(f)
    got = config.load_yaml(str(full))
    assert same(expected, got) is None, same(expected, got)
    runs, jruns = config.expand_experiment(got), jconfig.expand_experiment(
        expected)
    assert same(jruns, runs) is None, same(jruns, runs)
    # the writer's flow form reads back the same in both readers
    text = yaml_subset.dumps(got)
    assert same(expected, yaml_subset.loads(text)) is None
    assert same(expected, yaml.safe_load(text)) is None


SUBSET_CASES = [
    ("a: [1, 2.5, 5.0e-05, 1e-5, .5, -3, +4, 0]\n",
     {"a": [1, 2.5, 5.0e-05, "1e-5", 0.5, -3, 4, 0]}),
    ("a: [yes, No, on, OFF, True, false, ~, null, Null, '', \"x y\"]\n",
     {"a": [True, False, True, False, True, False, None, None, None, "", "x y"]}),
    ("a: &x {p: 1, q: [2, 3]}\nb:\n  <<: *x\n  q: 4\n  r: 5\n",
     {"a": {"p": 1, "q": [2, 3]}, "b": {"p": 1, "q": 4, "r": 5}}),
    ("a: &x {p: 1}\nb: &y {p: 2, s: 3}\nc:\n  <<: [*x, *y]\n",
     {"a": {"p": 1}, "b": {"p": 2, "s": 3}, "c": {"p": 1, "s": 3}}),
    ("k:\n- - [2, 1, 4]\n  - [2, 4, 2]\n- null\n- - x\n  - y: 1\n    z: [a]\n",
     {"k": [[[2, 1, 4], [2, 4, 2]], None, ["x", {"y": 1, "z": ["a"]}]]}),
    ("e: {n: L, g: C,\n  s: 0}  # comment\n# whole line\nf: 'it''s' # x\n",
     {"e": {"n": "L", "g": "C", "s": 0}, "f": "it's"}),
    ("a:\n  b:\n  c: 1\nd: data/coco/x_480.json\n",
     {"a": {"b": None, "c": 1}, "d": "data/coco/x_480.json"}),
]


@pytest.mark.parametrize("text,value", SUBSET_CASES)
def test_subset_forms_match_pyyaml(text, value):
    assert same(yaml.safe_load(text), value) is None
    assert same(yaml_subset.loads(text), value) is None


OUTSIDE = ["a: |\n  text\n", "a: >\n  text\n", "a: !!str 1\n",
           "--- \na: 1\n", "a: 017\n", "a: 0x1f\n", "a: 1:30\n",
           "a: 2001-12-14\n", "? a\n: 1\n", "a:\n\tb: 1\n",
           "a: b\n  c\n", "a: *missing\n"]


@pytest.mark.parametrize("text", OUTSIDE)
def test_outside_the_subset_raises(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.loads(text)
