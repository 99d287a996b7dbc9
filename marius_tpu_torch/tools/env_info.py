"""Print system, environment and GPU info (marius_env_info parity,
tools/distribution/marius_env_info.py:176).

Port of ``marius_tpu/tools/env_info.py``: the same keys, with ``torch``
(version, the CUDA version it was built for) in place of ``jax`` and the
CUDA devices torch sees. It reports; it runs nothing on a device.
"""

from __future__ import annotations

import platform
import sys
from typing import Dict


def collect_env_info() -> Dict[str, Dict]:
    info: Dict[str, Dict] = {
        "python": {
            "version": sys.version.split()[0],
            "executable": sys.executable,
        },
        "platform": {
            "system": platform.system(),
            "release": platform.release(),
            "machine": platform.machine(),
            "processor": platform.processor() or "unknown",
        },
    }
    try:
        import numpy
        info["numpy"] = {"version": numpy.__version__}
    except ImportError:
        pass
    import torch
    info["torch"] = {"version": str(torch.__version__), "cuda": torch.version.cuda}
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info["devices"] = {
        "count": count,
        "platform": "gpu" if count else "cpu",
        "kinds": sorted({torch.cuda.get_device_name(i) for i in range(count)}),
    }
    import marius_tpu_torch
    info["marius_tpu_torch"] = {"version": marius_tpu_torch.__version__}
    return info


def format_env_info() -> str:
    import yaml
    return yaml.safe_dump(collect_env_info(), sort_keys=False)
