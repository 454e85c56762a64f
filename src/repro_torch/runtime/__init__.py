"""Device layer of the port."""
from repro_torch.runtime.device import resolve_device  # noqa: F401
