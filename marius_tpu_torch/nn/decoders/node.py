"""Node decoders for node classification.

Port of ``marius_tpu/nn/decoders/node.py``: the reference's NoOpNodeDecoder
(noop_node_decoder.cpp:6) returns the encoder output unchanged — the class
logits come from the final encoder layer.
"""

from __future__ import annotations

import torch


def noop_node_decoder(encoded_nodes: torch.Tensor) -> torch.Tensor:
    return encoded_nodes
