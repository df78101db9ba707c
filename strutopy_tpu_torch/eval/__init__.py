from strutopy_tpu_torch.eval.heldout import eval_heldout, eval_heldout_torch, cut_in_half, split_corpus
from strutopy_tpu_torch.eval.residuals import check_residuals
from strutopy_tpu_torch.eval.diagnostics import (
    check_beta,
    ecdf,
    frex,
    label_topics,
    find_thoughts,
    find_topic,
    exclusivity,
    semantic_coherence,
    topic_quality,
    plot_topic_quality,
)
from strutopy_tpu_torch.eval.align import (
    align_models,
    align_topics,
    plot_alignment,
    topic_dissimilarity,
)
from strutopy_tpu_torch.eval.perplexity import perplexity
from strutopy_tpu_torch.eval.graph import topic_correlations, topic_graph, topic_graph_huge
from strutopy_tpu_torch.eval.effects import (
    effect_curve,
    effect_difference,
    effect_point_estimates,
    estimate_effect,
    estimate_effect_composition,
    estimate_content_effect,
    simulate_theta,
)
from strutopy_tpu_torch.eval.ldavis import to_ldavis, model_to_ldavis
from strutopy_tpu_torch.eval.predict import topic_lasso, plot_topic_lasso

__all__ = [
    "eval_heldout",
    "eval_heldout_torch",
    "cut_in_half",
    "split_corpus",
    "ecdf",
    "align_models",
    "align_topics",
    "check_beta",
    "find_topic",
    "frex",
    "plot_alignment",
    "topic_dissimilarity",
    "label_topics",
    "find_thoughts",
    "exclusivity",
    "semantic_coherence",
    "topic_quality",
    "plot_topic_quality",
    "perplexity",
    "topic_correlations",
    "topic_graph",
    "topic_graph_huge",
    "estimate_effect",
    "estimate_effect_composition",
    "estimate_content_effect",
    "simulate_theta",
    "effect_curve",
    "effect_difference",
    "effect_point_estimates",
    "to_ldavis",
    "model_to_ldavis",
    "topic_lasso",
    "plot_topic_lasso",
]
