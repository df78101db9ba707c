from strutopy_tpu_torch.corpus.bow import (
    PaddedCorpus,
    Vocabulary,
    pad_corpus,
    create_dtm,
    from_dtm,
    to_bow,
)

__all__ = ["PaddedCorpus", "Vocabulary", "pad_corpus", "create_dtm",
           "from_dtm", "to_bow"]
