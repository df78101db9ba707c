from strutopy_tpu_torch.eval.heldout import (
    cut_in_half,
    eval_heldout,
    eval_heldout_torch,
    split_corpus,
)
from strutopy_tpu_torch.eval.perplexity import perplexity

__all__ = ["cut_in_half", "eval_heldout", "eval_heldout_torch", "perplexity",
           "split_corpus"]
