"""Preprocessing tools of the port: converters, the dataset catalog, the
partitioner and the random dataset generators (``marius_tpu/tools/preprocess``)."""

from marius_tpu_torch.tools.preprocess.generate import (  # noqa: F401
    generate_random_dataset_lp,
    generate_random_dataset_nc,
)
