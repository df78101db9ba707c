from strutopy_tpu_torch.dgp.corpus_creation import CorpusCreation

__all__ = ["CorpusCreation"]
