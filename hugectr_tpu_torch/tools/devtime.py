"""Device time of the port's kernels on the card, from `torch.profiler`.

`device_ms(fn, names)` runs `fn` once to warm up, then 20 times under the
profiler, and returns the device time per call summed over the kernels
whose names hold one of `names`, and their launches per call. A CUDA-event
time around a 3 us kernel measures the host's enqueue rate instead.

Now and then a profile records no device activity at all, and in some
processes several in a row do; now and then one records only part of the
calls' launches (17 of 20), or none of them beside the spin kernels
below. Each wrapper launches the same kernels on every call of the same
inputs, so a profile whose launch count is 0 or not a multiple of the
calls is partial. Three short spin kernels run before and
after the calls inside each profile, and are left out of the sums, so that
launches lost at a profile's edges are theirs. A profile that is still
empty or partial is taken again, up to five times; if every one is, the
time is that of CUDA events around 20
back-to-back calls (an upper bound on the device time), the launches per
call are None (unknown), and the measurement is listed in `FALLBACKS`;
but if the last profile saw device kernels and none of `names`, `fn`
launches none of them, and `device_ms` raises.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

# device kernels of each wrapper (and of the library call beside it), by name
KERNEL_NAMES = {
    "onehot_fwd": ("onehot_fwd",),  # onehot_fwd_group, every forward launch
    "embedding_bag": ("",),  # every device kernel of the call (its fills included)
    "onehot_bwd": ("onehot_bwd", "cast_to_bf16"),
    "segscan": ("segscan_init", "segscan_lookback"),
    "index_add_": ("index",),
}

# the kernel names of each measurement that fell back to CUDA events
FALLBACKS: List[Tuple[str, ...]] = []


_SPIN = "spin_kernel"  # the kernel of torch.cuda._sleep


def _spin() -> None:
    for _ in range(3):
        torch.cuda._sleep(20_000)  # about 10 us each


def events_ms(fn: Callable[[], object], n: int = 20) -> float:
    """Milliseconds per call between CUDA events around `n` back-to-back calls."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn: Callable[[], object], names: Sequence[str], n: int = 20) -> Tuple[float, Optional[float]]:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(5):
        if attempt:
            print(f"devtime: empty or partial profile for {tuple(names)} (attempt {attempt})", file=sys.stderr)
            time.sleep(0.2)
        with torch.profiler.profile(activities=acts) as prof:
            _spin()
            for _ in range(n):
                fn()
            _spin()
            torch.cuda.synchronize()
        us, count, seen = 0.0, 0, []
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                seen.append(evt.key[:80])
                if _SPIN not in evt.key and any(k in evt.key for k in names):
                    us += evt.self_device_time_total
                    count += evt.count
        if seen and count and count % n == 0:
            break
    if seen and count == 0:
        raise AssertionError(f"the profiler saw no device kernel named {names}; it saw {seen}")
    if not seen or count % n:
        FALLBACKS.append(tuple(names))
        print(f"devtime: no whole profile in 5 for {tuple(names)}; CUDA events instead", file=sys.stderr)
        return events_ms(fn, n), None
    return us / 1e3 / n, count / n
