"""MESC core of the port: criticality, modes, policies and the serving lane."""
from repro_torch.core.scheduler import MODE_SEVERITY, Mode, Policy  # noqa: F401
from repro_torch.core.task import Crit  # noqa: F401
