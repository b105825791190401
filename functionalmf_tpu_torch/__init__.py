"""functionalmf_tpu_torch: the PyTorch / CUDA port of functionalmf_tpu.

The port runs ``ConstrainedNonconjugateBayesianTensorFiltering`` with
linear constraints on the curves and on the rows of W: GASS (grid or
shrink) over W rows, the blocked V update under the red-black, sequential
or joint schedule, optional EP centring, and the exact scale moves. With a
cell log-likelihood its GASS candidate log-likelihoods run in two
hand-written CUDA kernels on the card, each with and without EP
(``ops/fused_ll.py``, ``csrc/fused_ll.cu``), and in their plain PyTorch
versions on the CPU; without one, the user's black-box likelihood is
lifted over candidates and items with ``torch.func.vmap``
(``models/constrained.py``). ``NonconjugateBayesianTensorFiltering`` is the
unconstrained model by elliptical slice sampling. ``gass`` and
``elliptical_slice`` are the samplers in the JAX package's one-point call
forms, a ``torch.Generator`` in the key's place.
It also runs the conjugate and Polya-Gamma families,
``GaussianBayesianTensorFiltering``, ``BinomialBayesianTensorFiltering``
and ``NegativeBinomialBayesianTensorFiltering``, whose V update factors a
block-banded precision (``ops/banded.py``); these are plain PyTorch on
the CPU and on the card alike. Apps: the GDELT politics benchmark
(``apps/politics``), the flu-trends benchmark (``apps/flutrends``) and the
dose-response pipeline (``apps/doseresponse``). The package imports torch,
numpy and scipy, never jax and never ``functionalmf_tpu``.
"""
from functionalmf_tpu_torch.models.base import (BayesianTensorFiltering,
                                                packed_w_len, tril_mask)
from functionalmf_tpu_torch.models.binomial import (
    BinomialBayesianTensorFiltering)
from functionalmf_tpu_torch.models.constrained import (
    ConstrainedNonconjugateBayesianTensorFiltering)
from functionalmf_tpu_torch.models.gaussian import (
    GaussianBayesianTensorFiltering)
from functionalmf_tpu_torch.models.negbinom import (
    NegativeBinomialBayesianTensorFiltering)
from functionalmf_tpu_torch.models.nonconjugate import (
    NonconjugateBayesianTensorFiltering)
from functionalmf_tpu_torch.ops.mvn import (
    sample_mvn, sample_mvn_from_covariance, sample_mvn_from_precision)
from functionalmf_tpu_torch.ops.polyagamma import polya_gamma
from functionalmf_tpu_torch.ops.fused_ll import POISSON, CellFn
from functionalmf_tpu_torch.samplers.ess import elliptical_slice
from functionalmf_tpu_torch.samplers.gass import gass

__all__ = ["BayesianTensorFiltering",
           "GaussianBayesianTensorFiltering",
           "BinomialBayesianTensorFiltering",
           "NegativeBinomialBayesianTensorFiltering",
           "ConstrainedNonconjugateBayesianTensorFiltering",
           "NonconjugateBayesianTensorFiltering",
           "gass", "elliptical_slice",
           "polya_gamma", "sample_mvn", "sample_mvn_from_precision",
           "sample_mvn_from_covariance",
           "CellFn", "POISSON", "tril_mask", "packed_w_len"]

__version__ = "0.1.0"
