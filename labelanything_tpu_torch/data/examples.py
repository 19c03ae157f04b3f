"""Episode example/class sampling, a copy of
``labelanything_tpu/data/examples.py`` (reference:
label_anything/data/examples.py) but for one repair: a set of image names
is drawn from in sorted order (:func:`uniform_sampling`).

NumPy reimplementation of the example generators: for each query image, pick
a class subset (power-law/uniform sized, inverse-frequency weighted) and find
support images covering it, with frequency-based class dropping and backup
sampling when the image-set intersection is empty.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Set

import numpy as np


class SamplingFailureException(Exception):
    pass


def sample_power_law(n: int, alpha: float, rng: np.random.Generator) -> int:
    """Sample from {1..n} with P(x) ∝ x^-alpha (reference: examples.py:16-32)."""
    x = np.arange(1, n + 1, dtype=np.float64)
    probs = x ** (-alpha)
    probs /= probs.sum()
    return int(rng.choice(n, p=probs)) + 1


def sample_uniform(n: int, rng: np.random.Generator) -> int:
    return int(rng.integers(1, max(n, 2)))


def uniform_sampling(elem_set, sampled_elems, rng: np.random.Generator):
    # a set of ints iterates in an order fixed by the values (kept: it is
    # JAX's); a set of names in the order of Python's string hash, which
    # changes from process to process, so names are drawn sorted (ROADMAP
    # C14)
    if isinstance(elem_set, (set, frozenset)) and elem_set and not isinstance(
            next(iter(elem_set)), (int, np.integer)):
        elem_set = sorted(elem_set)
    to_sample_from = [c for c in elem_set if c not in sampled_elems]
    return to_sample_from[int(rng.integers(len(to_sample_from)))]


def sample_over_inverse_frequency(class_set, sampled, frequencies, rng,
                                  inverse=True):
    """(reference: examples.py:40-53)."""
    freqs = {int(k): frequencies[int(k)] for k in class_set if int(k) not in sampled}
    probs = {k: v + 1 for k, v in freqs.items()}
    tot = sum(probs.values())
    vals = np.asarray(
        [1 - v / tot for v in probs.values()] if inverse
        else [v / tot for v in probs.values()], np.float64,
    )
    if vals.sum() <= 0:
        vals = np.ones_like(vals)
    vals /= vals.sum()
    keys = list(probs.keys())
    return keys[int(rng.choice(len(keys), p=vals))]


class ExampleGenerator:
    """(reference: examples.py:56-280)."""

    def __init__(
        self,
        images_to_categories: Dict[int, Set[int]],
        categories_to_imgs: Dict[int, Set[int]],
        n_classes_sample_function,
        min_size: int = 1,
        rng: Optional[np.random.Generator] = None,
    ):
        self.images_to_categories = images_to_categories
        self.categories_to_imgs = categories_to_imgs
        self.n_classes_sample_function = n_classes_sample_function
        self.min_size = min_size
        self.rng = rng or np.random.default_rng()

    def sample_classes_from_query(self, class_list: Sequence[int],
                                  frequencies: Optional[Dict[int, int]] = None):
        """Subsample the query's class list (reference: examples.py:85-119)."""
        class_list = [int(c) for c in class_list]
        if len(class_list) <= self.min_size:
            return class_list
        n_elements = self.n_classes_sample_function(len(class_list), self.rng)
        if n_elements >= len(class_list):
            return class_list
        frequencies = frequencies if frequencies is not None else {
            c: 0 for c in class_list
        }
        sampled: List[int] = []
        if n_elements > len(class_list) // 2:
            for _ in range(len(class_list) - n_elements):
                sampled.append(sample_over_inverse_frequency(
                    class_list, sampled, frequencies, self.rng, inverse=False))
            return [c for c in class_list if c not in sampled]
        for _ in range(n_elements):
            sampled.append(sample_over_inverse_frequency(
                class_list, sampled, frequencies, self.rng))
        return sampled

    def get_image_ids_intersection(self, sublist, excluded_ids):
        inter = set.intersection(*[self.categories_to_imgs[c] for c in sublist])
        return inter - set(excluded_ids)

    def backup_sampling(self, class_set, frequencies):
        for cls in class_set:
            cls = int(cls)
            images_containing = self.get_image_ids_intersection([cls], [])
            if images_containing:
                frequencies.setdefault(cls, 0)
                return images_containing, [cls], frequencies
        raise SamplingFailureException("backup sampling failed")

    def generate_examples(self, query_image_id, image_classes, sampled_classes,
                          num_examples, num_classes=None):
        """(reference: examples.py:191-280). Returns (image_ids,
        examples_sampled_classes) where index 0 is the query."""
        if num_classes is not None:
            return self._generate_examples_fixed_classes(num_examples, num_classes)
        examples_sampled_classes: List[Set[int]] = []
        image_ids = [query_image_id]
        frequencies = {int(k): 0 for k in sampled_classes}
        for _ in range(num_examples):
            found = False
            example_classes = [int(c) for c in self.sample_classes_from_query(
                sampled_classes, frequencies)]
            example_id = None
            while not found:
                images_containing = self.get_image_ids_intersection(
                    example_classes, image_ids)
                if images_containing:
                    found = True
                    example_id = uniform_sampling(images_containing, image_ids, self.rng)
                else:
                    max_freq_class = max(
                        (k for k in frequencies if k in example_classes),
                        key=lambda k: frequencies[k],
                    )
                    example_classes.remove(max_freq_class)
                if not example_classes:
                    images_containing, example_classes, frequencies = (
                        self.backup_sampling([int(c) for c in image_classes],
                                             frequencies))
                    found = True
                    example_id = uniform_sampling(images_containing, [], self.rng)
            image_ids.append(example_id)
            for cat in example_classes:
                frequencies[cat] += 1
            examples_sampled_classes.append(set(example_classes))
        examples_sampled_classes.insert(0, set.union(*examples_sampled_classes))
        return image_ids, examples_sampled_classes

    def _generate_examples_fixed_classes(self, num_examples, num_classes):
        """(reference: examples.py:139-189) — used by COCO-20i style val."""
        categories = list(self.categories_to_imgs.keys())
        perm = self.rng.permutation(len(categories))[:num_classes]
        classes = [categories[i] for i in perm]
        query_classes = classes.copy()
        if self.rng.random() > 0.5:
            query_classes = [classes[int(self.rng.integers(len(classes)))]]
            query_image_id = uniform_sampling(
                self.categories_to_imgs[query_classes[0]], [], self.rng)
        else:
            while True:
                images_containing = self.get_image_ids_intersection(query_classes, [])
                if images_containing:
                    query_image_id = uniform_sampling(images_containing, [], self.rng)
                    break
                query_classes.pop()
                if not query_classes:
                    raise SamplingFailureException(
                        "Cannot find an image containing the query classes")
        image_ids = [query_image_id]
        total_query = {c for c in self.images_to_categories[query_image_id]
                       if c in classes}
        example_classes: List[Set[int]] = [total_query]
        for _ in range(num_examples):
            for cls in classes:
                example_id = uniform_sampling(
                    self.categories_to_imgs[cls], image_ids, self.rng)
                image_ids.append(example_id)
                example_classes.append({
                    c for c in self.images_to_categories[example_id] if c in classes
                })
        return image_ids, example_classes


class _PowerLawSampler:
    """Picklable n-ways sampler (datasets cross process boundaries in the
    process-mode EpisodeLoader; lambdas don't pickle)."""

    def __init__(self, alpha: float):
        self.alpha = alpha

    def __call__(self, n, rng):
        return sample_power_law(n, self.alpha, rng)


class _FixedWaysSampler:
    def __init__(self, n_ways: int):
        self.n_ways = n_ways

    def __call__(self, n, rng):
        return min(n, self.n_ways)


class _AllWaysSampler:
    def __call__(self, n, rng):
        return n


class NWayExampleGenerator(ExampleGenerator):
    """(reference: examples.py:164-196)."""

    def __init__(self, images_to_categories, categories_to_imgs, n_ways="max",
                 min_size=1, alpha=-2.0, sample_function="power_law",
                 rng: Optional[np.random.Generator] = None):
        if n_ways == "max":
            if sample_function == "power_law":
                fn = _PowerLawSampler(alpha)
            elif sample_function == "uniform":
                fn = sample_uniform
            else:
                raise ValueError(f"Unknown sample function {sample_function}")
        else:
            fn = _FixedWaysSampler(n_ways)
        super().__init__(images_to_categories, categories_to_imgs, fn,
                         min_size, rng)


class MaxWayMinShotsExampleGenerator(ExampleGenerator):
    """Min covering-set of support images (reference: examples.py:198-268)."""

    def __init__(self, images_to_categories, categories_to_imgs, min_size=1,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(images_to_categories, categories_to_imgs,
                         _AllWaysSampler(), min_size, rng)

    def generate_examples(self, query_image_id, image_classes, sampled_classes,
                          num_examples=None, num_classes=None):
        examples_sampled_classes: List[Set[int]] = []
        image_ids = [query_image_id]
        remaining = {int(c) for c in sampled_classes}
        while remaining:
            size = len(remaining)
            found = False
            for i in range(size):
                for included in itertools.combinations(sorted(remaining), size - i):
                    images_containing = self.get_image_ids_intersection(
                        list(included), image_ids)
                    if images_containing:
                        example_id = uniform_sampling(images_containing, image_ids,
                                                      self.rng)
                        found = True
                        break
                if found:
                    image_ids.append(example_id)
                    example_classes = set(included).union(
                        self.images_to_categories[example_id])
                    examples_sampled_classes.append(example_classes)
                    remaining -= set(included)
                    break
            if not found:
                raise SamplingFailureException("no covering image found")
        examples_sampled_classes.insert(0, {int(c) for c in sampled_classes})
        return image_ids, examples_sampled_classes


def build_example_generator(images_to_categories, categories_to_imgs,
                            n_ways="max", n_shots=None, min_size=1, alpha=-2.0,
                            sample_function="power_law",
                            rng: Optional[np.random.Generator] = None):
    """(reference: examples.py:270-292)."""
    if n_shots == "min":
        return MaxWayMinShotsExampleGenerator(
            images_to_categories, categories_to_imgs, min_size, rng)
    return NWayExampleGenerator(
        images_to_categories, categories_to_imgs, n_ways, min_size, alpha,
        sample_function=sample_function, rng=rng)
