"""Device time of the port's kernels on the card, from `torch.profiler`.

`device_ms(fn, names)` runs `fn` once to warm up, then 20 times under the
profiler, and returns the device time per call summed over the kernels
whose names hold one of `names`, and their launches per call. A profile
that records no device activity at all is taken again, up to three times.
A CUDA-event time around a 3 us kernel measures the host's enqueue rate
instead.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

# device kernels of each wrapper (and of the library call beside it), by name
KERNEL_NAMES = {
    "onehot_fwd": ("onehot_fwd",),  # onehot_fwd_group, every forward launch
    "embedding_bag": ("",),  # every device kernel of the call (its fills included)
    "onehot_bwd": ("onehot_bwd", "cast_to_bf16"),
    "segscan": ("segscan_init", "segscan_lookback"),
    "index_add_": ("index",),
}


def device_ms(fn: Callable[[], object], names: Sequence[str], n: int = 20) -> Tuple[float, float]:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us, count, seen = 0.0, 0, []
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                seen.append(evt.key[:80])
                if any(k in evt.key for k in names):
                    us += evt.self_device_time_total
                    count += evt.count
        if seen:  # now and then a profile records no device activity at all
            break
    if count == 0:
        raise AssertionError(f"the profiler saw no device kernel named {names}; it saw {seen}")
    return us / 1e3 / n, count / n
