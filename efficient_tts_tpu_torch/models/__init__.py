"""Model registry of the acoustic models the pipeline serves and the train step trains.

Counterpart of `efficient_tts_tpu/models/__init__.py` (`MODEL_REGISTRY`,
`model_module_for`): each name maps to its (config class, model class).
Both models offer `infer_durations` and `infer_decode` with the same
signatures, which is all `pipeline.py` calls. A model class whose `TRAINS`
is true has a training forward, `model(text, text_lengths, mel,
mel_lengths, gen=..., deterministic=...)`, which is all
`train/efts_train_step.py` calls: both models.
"""

from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer, EftsTransformerConfig

MODEL_REGISTRY = {
    "EfficientTTSCNN": (EftsCNNConfig, EftsCNN),
    "EfficientTTSTransformer": (EftsTransformerConfig, EftsTransformer),
}


def model_class_for(cfg, training: bool = False):
    """The model class for a config instance; raises for a config no
    registered model takes, and with `training` for a model whose training
    forward is not ported."""
    for cfg_cls, model_cls in MODEL_REGISTRY.values():
        if isinstance(cfg, cfg_cls):
            if training and not model_cls.TRAINS:
                raise NotImplementedError(f"{model_cls.__name__} has no training forward in the port yet")
            return model_cls
    raise TypeError(f"no acoustic model is registered for {type(cfg).__name__}")
