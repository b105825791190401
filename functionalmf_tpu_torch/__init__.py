"""functionalmf_tpu_torch: the PyTorch / CUDA port of functionalmf_tpu.

The port runs ``ConstrainedNonconjugateBayesianTensorFiltering`` with a
cell log-likelihood and linear constraints: GASS over W rows, the blocked
V update under the red-black, sequential or joint schedule, optional EP
centring, and the exact scale moves; and the GDELT politics benchmark
(``apps/politics``). Its GASS candidate log-likelihoods run in two
hand-written CUDA kernels on the card, each with and without EP
(``ops/fused_ll.py``, ``csrc/fused_ll.cu``), and in their plain PyTorch
versions on the CPU. The package imports torch, numpy and scipy, never
jax and never ``functionalmf_tpu``.
"""
from functionalmf_tpu_torch.models.base import (BayesianTensorFiltering,
                                                packed_w_len, tril_mask)
from functionalmf_tpu_torch.models.constrained import (
    ConstrainedNonconjugateBayesianTensorFiltering)
from functionalmf_tpu_torch.ops.fused_ll import POISSON, CellFn

__all__ = ["BayesianTensorFiltering",
           "ConstrainedNonconjugateBayesianTensorFiltering",
           "CellFn", "POISSON", "tril_mask", "packed_w_len"]

__version__ = "0.1.0"
