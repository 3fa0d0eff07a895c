# Root conftest: tests run on a virtual 8-device CPU mesh by default so the
# multi-device sharding paths compile and execute deterministically without
# accelerators. Tests marked `gpu` need the card: run them there with
# JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
