"""Workload generation: Poisson arrivals over the task mix (paper §IV-A)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.types import Request
from repro_torch.workload.apps import TASKS, make_request


def poisson_workload(rate: float, duration: float, *, seed: int = 0,
                     tasks: Optional[Sequence[str]] = None,
                     max_len: int = 1024, max_gen: int = 1024
                     ) -> List[Request]:
    """Requests with exponential inter-arrival gaps at ``rate`` req/s over
    ``duration`` seconds, tasks drawn uniformly from the mix."""
    rng = np.random.default_rng(seed)
    task_list = list(tasks or TASKS)
    t, out = 0.0, []
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration:
            return out
        r = make_request(str(rng.choice(task_list)), rng, max_len=max_len,
                         max_gen=max_gen)
        r.arrival_time = t
        out.append(r)
