"""MESC core of the port: criticality, modes, policies, the serving
lane, and the simulation side —

  isa/program   — Gemmini^RT ISA + workload->instruction-stream compiler
  task/taskgen  — task model, TCB and UUnifast task sets (SS VIII)
  simulator     — run metrics (the event engine is not ported yet)
  simulator_vec — batch tables and release phases of the lockstep engine
  simulator_jit — the lockstep engine in CUDA graphs (simulate_jbatch)
"""
from repro_torch.core.isa import Instruction, Op  # noqa: F401
from repro_torch.core.program import (Program, build_program,  # noqa: F401
                                      workload_library)
from repro_torch.core.scheduler import MODE_SEVERITY, Mode, Policy  # noqa: F401
from repro_torch.core.simulator import RunMetrics  # noqa: F401
from repro_torch.core.task import TCB, Crit, Status, TaskParams  # noqa: F401
from repro_torch.core.taskgen import (generate_taskset,  # noqa: F401
                                      generate_taskset_batch, point_seed,
                                      uunifast)
