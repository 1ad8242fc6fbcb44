"""Model registry of the acoustic models the pipeline serves.

Counterpart of `efficient_tts_tpu/models/__init__.py` (`MODEL_REGISTRY`,
`model_module_for`) for the two inference models: each name maps to its
(config class, model class). Both models offer `infer_durations` and
`infer_decode` with the same signatures, which is all `pipeline.py` calls.
"""

from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer, EftsTransformerConfig

MODEL_REGISTRY = {
    "EfficientTTSCNN": (EftsCNNConfig, EftsCNN),
    "EfficientTTSTransformer": (EftsTransformerConfig, EftsTransformer),
}


def model_class_for(cfg):
    """The model class for a config instance; raises for a config no
    registered model takes."""
    for cfg_cls, model_cls in MODEL_REGISTRY.values():
        if isinstance(cfg, cfg_cls):
            return model_cls
    raise TypeError(f"no acoustic model is registered for {type(cfg).__name__}")
