"""MESC core of the port (own copy of the reference's ``core/``):
instruction-level preemption for streaming accelerators, the serving
lane, and the simulation side —

  isa/program   — Gemmini^RT ISA + workload->instruction-stream compiler
  remapper      — scratchpad bank allocation (address remapper)
  executor      — virtual accelerator w/ config-copy buffer + context switch
  scheduler     — Alg. 1 + LO/transition/HI mode rules (+ NP/LP/AMC baselines)
  simulator     — cycle-level DES for the paper's experiments (host)
  simulator_vec — the same semantics, hundreds of points per NumPy step
  simulator_jit — the lockstep engine in CUDA graphs (simulate_jbatch)
  task/taskgen  — task model, TCB and UUnifast task sets (SS VIII)
  wcrt          — response-time analysis (Eqs. 1-11) + partitioned variant
  monitor       — TCB registry + LO-WCET timers (real-executor path)
  platform      — N-instance accelerator pool, partition heuristics,
                  LO migration-on-idle (multi-accelerator scale-out)
"""
from repro_torch.core.isa import Instruction, Op  # noqa: F401
from repro_torch.core.program import (Program, build_program,  # noqa: F401
                                      workload_library)
from repro_torch.core.remapper import AddressRemapper  # noqa: F401
from repro_torch.core.executor import GemminiRT  # noqa: F401
from repro_torch.core.scheduler import (MODE_SEVERITY, Mode,  # noqa: F401
                                        ModeCoordinator, Policy, pick_next,
                                        update_mode)
from repro_torch.core.simulator import (MCSSimulator,  # noqa: F401
                                        MultiAccelSimulator,
                                        MultiRunMetrics, RunMetrics,
                                        simulate, simulate_batch,
                                        simulate_multi)
from repro_torch.core.task import TCB, Crit, Status, TaskParams  # noqa: F401
from repro_torch.core.taskgen import (generate_taskset,  # noqa: F401
                                      generate_taskset_batch, point_seed,
                                      uunifast)
from repro_torch.core.wcrt import (AnalysisConstants,  # noqa: F401
                                   PartitionedSchedulability, analyze,
                                   analyze_partitioned,
                                   longest_instruction)
from repro_torch.core.platform import (AcceleratorPool,  # noqa: F401
                                       Assignment, MigrationPolicy,
                                       partition, utilization)
from repro_torch.core.monitor import TaskMonitor  # noqa: F401
