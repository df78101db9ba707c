"""strutopy_tpu_torch: the Structural Topic Model on PyTorch and CUDA.

The port of ``strutopy_tpu`` (JAX) to PyTorch, with the E-step's Newton
solve as hand-written CUDA kernels for Hopper (``csrc/``): the fit
(spectral or random init, LDA beta or the content model, checkpoints),
heldout evaluation, and serving from saved artifacts.
It imports torch and numpy only, never jax or ``strutopy_tpu``.

Precision: every model quantity is true float32.  A float32 matmul or
convolution on the GPU may otherwise run in TF32 (about three decimal
digits), so TF32 is turned off here, once, for the process — the
counterpart of the JAX package's ``Precision.HIGH`` on its finalize and
linear algebra.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, Vocabulary, pad_corpus  # noqa: E402
from strutopy_tpu_torch.dgp.corpus_creation import CorpusCreation  # noqa: E402
from strutopy_tpu_torch.eval.heldout import cut_in_half, eval_heldout, split_corpus  # noqa: E402
from strutopy_tpu_torch.models.config import STMConfig  # noqa: E402
from strutopy_tpu_torch.models.serving import (  # noqa: E402
    ThetaServer,
    infer_from_artifacts,
    infer_theta,
)
from strutopy_tpu_torch.models.stm import STM  # noqa: E402

__all__ = [
    "PaddedCorpus",
    "Vocabulary",
    "pad_corpus",
    "STMConfig",
    "STM",
    "ThetaServer",
    "infer_from_artifacts",
    "infer_theta",
    "CorpusCreation",
    "eval_heldout",
    "cut_in_half",
    "split_corpus",
]
