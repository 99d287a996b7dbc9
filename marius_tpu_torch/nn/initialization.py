"""Tensor initialization distributions.

Port of ``marius_tpu/nn/initialization.py`` (InitConfig, compute_fans,
initialize_tensor; reference nn/initialization.cpp:7-119). Draws come from an
explicit ``torch.Generator`` where the JAX version takes a PRNG key; the two
generators give different numbers, so only the distributions match.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Mirrors the reference InitConfig (configuration/config.h + marius_config.py:130)."""

    distribution: str = "GLOROT_UNIFORM"  # ZEROS|ONES|CONSTANT|UNIFORM|NORMAL|GLOROT_UNIFORM|GLOROT_NORMAL
    constant: float = 0.0
    scale_factor: float = 0.001
    mean: float = 0.0
    std: float = 1.0


def compute_fans(shape: Sequence[int]) -> Tuple[int, int]:
    """Fan computation identical to initialization.cpp:7-24."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    # 2D: (fan_in, fan_out) = (shape[0], shape[1]); >2D uses the last two dims.
    return shape[-2], shape[-1]


def _uniform(generator, shape, dtype, low, high):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return u * (high - low) + low


def initialize_tensor(
    generator: torch.Generator,
    config: InitConfig,
    shape: Sequence[int],
    dtype=torch.float32,
    fans: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Draw a tensor from the configured distribution on the generator's device.

    ``fans`` overrides the fan computation — used to initialize a sub-block of a
    larger tensor with the full tensor's scaling (initialize_subtensor,
    initialization.cpp:101-119).
    """
    dist = config.distribution.upper()
    shape = tuple(int(s) for s in shape)
    device = generator.device

    if dist == "ZEROS":
        return torch.zeros(shape, dtype=dtype, device=device)
    if dist == "ONES":
        return torch.ones(shape, dtype=dtype, device=device)
    if dist == "CONSTANT":
        return torch.full(shape, config.constant, dtype=dtype, device=device)
    if dist == "UNIFORM":
        return config.scale_factor * _uniform(generator, shape, dtype, -1.0, 1.0)
    if dist == "NORMAL":
        return config.mean + config.std * torch.randn(
            shape, generator=generator, dtype=dtype, device=device)

    fan_in, fan_out = fans if fans is not None else compute_fans(shape)
    if dist == "GLOROT_UNIFORM":
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(generator, shape, dtype, -limit, limit)
    if dist == "GLOROT_NORMAL":
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return std * torch.randn(shape, generator=generator, dtype=dtype, device=device)
    raise ValueError(f"Unknown initialization distribution: {config.distribution}")
