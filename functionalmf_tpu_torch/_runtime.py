"""Device checks, float32 matmul precision and the per-sweep RNG.

* ``resolve_device`` turns the model's ``device=`` argument (``"cuda"``
  unless the caller asks for the CPU) into a ``torch.device`` and refuses
  a CUDA device that is not there. Nothing switches to the CPU on its own.
* ``require_full_f32`` turns TF32 off for matmuls and convolutions and
  asserts it. On the H100, TF32 (about three decimal digits) is the hazard
  that the JAX package guards against with ``Precision.HIGHEST``
  (functionalmf_tpu/models/constrained.py:409-417, samplers/gass.py:106-109,
  ops/banded.py:_mm_f32): constraint geometry and Cholesky pivots at the
  horseshoe's dynamic range need full float32.
* ``tree_map`` / ``tree_leaves`` walk a data pytree (dicts, tuples and
  lists of leaves), the structure the black-box likelihoods take their
  data in (``jax.tree_util`` in the JAX package).
* ``SweepRNG`` replaces the JAX package's ``_fold`` key derivation
  (functionalmf_tpu/models/base.py:71-74, 622-625, 708-711): one
  ``torch.Generator`` on the model's device, re-seeded at every sweep from
  (seed, stream, absolute sweep index). Within a sweep the sites draw in a
  fixed order, so a run cut into chunks draws exactly what an uncut run
  draws.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "require_full_f32", "mix_seed", "SweepRNG",
           "tree_map", "tree_leaves"]

_MASK64 = (1 << 64) - 1


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def tree_map(fn, tree):
    """``fn`` on every leaf of a pytree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a pytree, dict values in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def mix_seed(*ints) -> int:
    """A 64-bit generator seed from a tuple of non-negative integers."""
    h = 0
    for v in ints:
        h = _splitmix64(h ^ (int(v) & _MASK64))
    return h


class SweepRNG:
    """One generator on ``device``; ``at(stream, step)`` re-seeds it from
    (seed, stream, step) and returns it."""

    INIT = 0xC0FFEE    # state initialisation draws
    SWEEP = 0x515B5    # Gibbs sweeps of run_gibbs
    HOOK = 0xCB        # run_gibbs's traced_callback, a site of its own
    PGDS = 0x9D5       # sweeps of the PGDS sampler (models/pgds.py)

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.gen = torch.Generator(device=device)

    def at(self, stream: int, step: int) -> torch.Generator:
        self.gen.manual_seed(mix_seed(self.seed, stream, step))
        return self.gen
