from marius_tpu_torch.config.schema import (  # noqa: F401
    DatasetConfig,
    EvaluationConfig,
    MariusConfig,
    StorageConfig,
    TrainingConfig,
    load_config,
)
