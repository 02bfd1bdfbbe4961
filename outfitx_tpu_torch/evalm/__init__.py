from outfitx_tpu_torch.evalm.metrics import (  # noqa: F401
    binary_classification_metrics,
    fitb_accuracy,
    recall_at_k,
    roc_auc,
)
