"""strutopy_tpu_torch: the Structural Topic Model on PyTorch and CUDA.

The port of ``strutopy_tpu`` (JAX) to PyTorch, with the E-step's Newton
solve as hand-written CUDA kernels for Hopper (``csrc/``): the fit
(spectral or random init, LDA beta or the content model, checkpoints),
heldout evaluation, serving from saved artifacts and from raw text,
out-of-core fits (``StreamedEM``), the post-fit analysis of ``eval/``,
text preprocessing and corpus readers (``corpus/``, with the native
ingest library built from ``native/``), the experiment pipeline
(``pipeline.py``) and the command line (``python -m strutopy_tpu_torch.cli``).
It imports torch and numpy only, never jax or ``strutopy_tpu``.

Precision: every model quantity is true float32.  A float32 matmul on
the GPU may run in TF32 (about three decimal digits) when the host
program allows it, so every entry point runs inside
``utils.precision.float32_matmul``, which turns TF32 off and restores the
flags on exit; importing the package changes nothing.
"""

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, Vocabulary, pad_corpus
from strutopy_tpu_torch.dgp.corpus_creation import CorpusCreation
from strutopy_tpu_torch.eval.heldout import cut_in_half, eval_heldout, split_corpus
from strutopy_tpu_torch.models.config import STMConfig
from strutopy_tpu_torch.models.serving import (
    ThetaServer,
    infer_from_artifacts,
    infer_theta,
)
from strutopy_tpu_torch.models.stm import STM
from strutopy_tpu_torch.models.streaming import StreamedEM

__version__ = "0.1.0"

__all__ = [
    "PaddedCorpus",
    "Vocabulary",
    "pad_corpus",
    "STMConfig",
    "STM",
    "ThetaServer",
    "infer_from_artifacts",
    "infer_theta",
    "StreamedEM",
    "CorpusCreation",
    "eval_heldout",
    "cut_in_half",
    "split_corpus",
    "__version__",
]
