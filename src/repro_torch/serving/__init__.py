"""Open-loop serving front end: traffic, admission control and SLO
accounting over the port's MESC serving stack (twin of the reference's
``serving`` package).

  * :mod:`repro_torch.serving.traffic` — arrival processes (Poisson,
    diurnal, heavy-tail, trace replay) on counter-based splitmix64 draws
    keyed ``(seed, stream, arrival_index)``, no host RNG;
  * :mod:`repro_torch.serving.frontend` — the admission front door (HI
    drains before LO, optional LO live cap) feeding
    ``core.serving.MultiLaneServer``, plus the virtual-clock / virtual
    service-time drive;
  * :mod:`repro_torch.serving.slo` — per-request SLO metrics
    (p50/p99/p999 latency and TTFT, deadline-miss rate, goodput);
  * :mod:`repro_torch.serving.fig12` — the fig12 point function.

The modelless parts run on the host; ``launch.serve``'s ``--arrivals``
drive serves a real model on the card through the same front door.
"""
from repro_torch.serving.clock import VirtualClock, wall_clock
from repro_torch.serving.traffic import (PROCESS_KINDS, ArrivalSpec,
                                         Diurnal, HeavyTail, Poisson,
                                         Trace, arrival_times,
                                         build_workload, crn_u01,
                                         load_trace, make_process,
                                         save_trace)
from repro_torch.serving.slo import nearest_rank, slo_summary
from repro_torch.serving.frontend import (FrontDoor, VirtualModel,
                                          make_request,
                                          run_virtual_serving)

__all__ = [
    "VirtualClock", "wall_clock",
    "PROCESS_KINDS", "ArrivalSpec", "Poisson", "Diurnal", "HeavyTail",
    "Trace",
    "arrival_times", "build_workload", "crn_u01", "make_process",
    "save_trace", "load_trace",
    "nearest_rank", "slo_summary",
    "FrontDoor", "VirtualModel", "make_request", "run_virtual_serving",
]
