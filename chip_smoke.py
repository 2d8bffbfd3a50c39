#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`hugectr_tpu_torch`) on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the repo root, on a machine with a card)

Each phase prints one JSON line with its own seconds:

1. "card": the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the nvcc build of the kernels (csrc/*.cu, sm_90a).
2. "kernel": each hand-written kernel against its plain PyTorch version on
   the card, at the flagship's shapes, in float32 and bfloat16: the error
   scaled by the sum of |inputs| that went into each output element (the
   kernels sum in another order, one of them with atomics) against a stated
   tolerance, and the kernel's, the plain version's and one PyTorch library
   call's times (CUDA events, median of 20 samples of 5 calls, after
   warm-up), with the bound the card's memory rate or float32 rate puts on
   the same work. `device_ms` is the kernel's device time per call from
   `torch.profiler` over 20 calls, summing the kernel's own launches
   (`hugectr_tpu_torch/tools/devtime.py`); the fraction of the bound is
   judged on it. Then
   the edge cases of the designs: every one-hot key on one row, V at the
   backward's shared-memory tile edges, all padding, accumulation into a
   caller's buffers; segscan over one segment, all heads, K at a tile's
   edges, K below a tile and K = 0, and two runs compared bitwise.
3. "tiny_parity": the tiny DLRM-DCNv2 trained 3 steps on the card (kernels)
   and on the CPU (plain versions) from the same state: losses and tables
   must agree.
4. "main_path": the flagship DLRM-DCNv2 at full width (26 MLPerf tables,
   ev 128, vocab_cap 2,000,000, batch 16,384, rowwise AdaGrad, fp32) built
   with `build_dlrm_dcnv2` and trained 6 `Model.train()` steps. Launch
   counters are set to 0 just before the steps and read just after; every
   kernel must have launched. Reports the losses (finite), ms/step and ex/s
   (median of steps 2-6), peak device memory and each group's update route.

Then a "kernels" JSON line (per kernel: source, the TPU kernel it replaces,
main-path launches, error, ms, device_ms, plain_ms, bound_ms, bound_by,
library_ms, for the float32 flagship case with the most device time), a
line with the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Any failure exits non-zero before that line;
so does a machine without CUDA.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
B = 16384
E = 128
ALPHA = 1.05
# tolerances on |kernel - plain| / (sum of |inputs| into the element):
# float32 sums in another order (atomics for the backward); bfloat16 adds
# one rounding of the output (2^-8 relative)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, samples: int = 20, inner: int = 5, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled_err(got, want, scale) -> float:
    import torch

    d = (got.double() - want.double()).abs() / (scale.double() + 1e-30)
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


def power_law(rng, vocab, size):
    import numpy as np

    x = rng.random(size)
    a = 1.0 - ALPHA
    y = ((float(vocab) ** a - 1.0) * x + 1.0) ** (1.0 / a)
    return np.clip(np.round(y) - 1.0, 0, vocab - 1).astype(np.int64)


def kernel_checks(torch, results):
    """Phase 2: each kernel against its plain version at the flagship's
    shapes (one-hot: tables 3, 24 and 5; segscan: table 21's K), then the
    edge cases of the designs."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    import numpy as np
    import torch.nn.functional as F

    from hugectr_tpu_torch.ops import onehot_matmul as oh
    from hugectr_tpu_torch.ops import segscan as ss

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for name, v, h in (("table3", 7424, 2), ("table24", 108, 40), ("table5", 3, 1)):
        keys = torch.as_tensor(power_law(rng, v, (B, h)).astype(np.int32), device=dev)
        for dt in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            dname = str(dt).split(".")[1]
            table = torch.as_tensor(rng.standard_normal((v, E), dtype=np.float32), device=dev).to(dt)
            d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev).to(dt)
            isz = table.element_size()
            uniq = int(torch.unique(keys).numel())
            # forward
            got = oh.onehot_matmul_fwd(keys, table)
            want = oh.onehot_matmul_fwd_plain(keys, table)
            scale = oh.onehot_matmul_fwd_plain(keys, table.float().abs())
            torch.cuda.synchronize()
            err = scaled_err(got, want, scale)
            abs_err = float((got.float() - want.float()).abs().max())
            keys_l = keys.long()
            b_ms, b_by = bound(keys.numel() * 4 + uniq * E * isz + B * E * isz, B * h * E)
            dms, per_call = device_ms(lambda: oh.onehot_matmul_fwd(keys, table), KERNEL_NAMES["onehot_fwd"])
            rec = dict(
                kernel="onehot_fwd", case=name, dtype=dname, B=B, V=v, h=h, E=E,
                scaled_err=err, max_abs_err=abs_err, tol=TOL[dname],
                ms=time_ms(lambda: oh.onehot_matmul_fwd(keys, table)),
                device_ms=dms, device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: oh.onehot_matmul_fwd_plain(keys, table)),
                library_ms=time_ms(lambda: F.embedding_bag(keys_l, table, mode="sum")),
                library="torch.nn.functional.embedding_bag(mode='sum')",
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            )
            results.append(rec)
            # backward
            grad, cnt = oh.onehot_matmul_bwd(keys, d, v, dt)
            want_g, want_c = oh.onehot_matmul_bwd_plain(keys, d, v, dt)
            scale_g, _ = oh.onehot_matmul_bwd_plain(keys, d.float().abs(), v, torch.float32)
            torch.cuda.synchronize()
            cnt_ok = bool(torch.equal(cnt, want_c))
            d_rep = d.repeat_interleave(h, dim=0)
            flat = keys_l.reshape(-1)
            b_ms, b_by = bound(keys.numel() * 4 + B * E * isz + v * E * isz + v * 4, B * h * E)
            dms, per_call = device_ms(lambda: oh.onehot_matmul_bwd(keys, d, v, dt), KERNEL_NAMES["onehot_bwd"])

            def library():
                return torch.zeros((v, E), dtype=dt, device=dev).index_add_(0, flat, d_rep)

            rec2 = dict(
                kernel="onehot_bwd", case=name, dtype=dname, B=B, V=v, h=h, E=E,
                route=oh.bwd_route(B, h, v, E, dev),
                scaled_err=scaled_err(grad, want_g, scale_g),
                max_abs_err=float((grad.float() - want_g.float()).abs().max()),
                counts_exact=cnt_ok, tol=TOL[dname],
                ms=time_ms(lambda: oh.onehot_matmul_bwd(keys, d, v, dt)),
                device_ms=dms, device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: oh.onehot_matmul_bwd_plain(keys, d, v, dt)),
                library_ms=time_ms(library),
                library_device_ms=device_ms(library, KERNEL_NAMES["index_add_"])[0],
                library="Tensor.index_add_ (grad only; library_device_ms: the index_add_ kernel)",
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            )
            results.append(rec2)
            rec2["seconds"] = rec["seconds"] = time.perf_counter() - t0
            emit(rec)
            emit(rec2)
            if not (rec["scaled_err"] <= TOL[dname] and rec2["scaled_err"] <= TOL[dname] and cnt_ok):
                raise AssertionError(f"one-hot kernel disagrees with its plain version: {rec} {rec2}")
    # padding and ragged shapes: B and V not multiples of anything, -1 keys
    for v, h in ((57, 3), (600, 6)):
        keys_np = power_law(rng, v, (1000, h)).astype(np.int32)
        keys_np[rng.random(keys_np.shape) < 0.2] = -1
        keys = torch.as_tensor(keys_np, device=dev)
        table = torch.as_tensor(rng.standard_normal((v, 24), dtype=np.float32), device=dev)
        d = torch.as_tensor(rng.standard_normal((1000, 24), dtype=np.float32), device=dev)
        e1 = scaled_err(
            oh.onehot_matmul_fwd(keys, table), oh.onehot_matmul_fwd_plain(keys, table),
            oh.onehot_matmul_fwd_plain(keys, table.abs()),
        )
        g, c = oh.onehot_matmul_bwd(keys, d, v, torch.float32)
        wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32)
        e2 = scaled_err(g, wg, oh.onehot_matmul_bwd_plain(keys, d.abs(), v, torch.float32)[0])
        emit(dict(kernel="onehot", case=f"padded_V{v}_h{h}", fwd_err=e1, bwd_err=e2,
                  counts_exact=bool(torch.equal(c, wc))))
        if not (e1 <= TOL["float32"] and e2 <= TOL["float32"] and torch.equal(c, wc)):
            raise AssertionError(f"one-hot kernel disagrees on padded keys (V={v}, h={h})")
    onehot_bwd_edges(torch, np, rng, oh, dev)
    segscan_checks(torch, np, rng, ss, dev, results)


def onehot_bwd_edges(torch, np, rng, oh, dev):
    """The backward's edge cases: every key on one row, V one below, at and
    one above the privatised route's shared-memory limit, the engine's
    largest table, all padding, bfloat16 output, accumulation into a
    caller's buffers."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    vt = oh.bwd_tile_rows(E, dev)
    cases = [("one_row", np.full((B, 40), 5, np.int32), 108, torch.float32)]
    # V one below and at the most rows the privatised route holds in shared
    # memory, and one above (global route)
    for v in (vt - 1, vt, vt + 1):
        cases.append((f"V{v}_h40", power_law(rng, v, (B, 40)).astype(np.int32), v, torch.float32))
    # the engine's largest table (global route) at high and low hotness
    for hh in (128, 2):
        cases.append((f"V8192_h{hh}", power_law(rng, 8192, (B, hh)).astype(np.int32), 8192,
                      torch.float32))
    cases.append(("all_padding", np.full((B, 3), -1, np.int32), 100, torch.float32))
    cases.append(("one_row_bf16", np.full((B, 40), 5, np.int32), 108, torch.bfloat16))
    for name, keys_np, v, dt in cases:
        keys = torch.as_tensor(keys_np, device=dev)
        d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev).to(dt)
        g, c = oh.onehot_matmul_bwd(keys, d, v, dt)
        wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, dt)
        sg, _ = oh.onehot_matmul_bwd_plain(keys, d.float().abs(), v, torch.float32)
        dname = str(dt).split(".")[1]
        rec = dict(kernel="onehot_bwd", case=name, dtype=dname, B=B, V=v, h=keys_np.shape[1],
                   tile_rows=vt, route=oh.bwd_route(B, keys_np.shape[1], v, E, dev),
                   scaled_err=scaled_err(g, wg, sg), tol=TOL[dname],
                   counts_exact=bool(torch.equal(c, wc)), dtype_ok=g.dtype == dt,
                   device_ms=device_ms(lambda: oh.onehot_matmul_bwd(keys, d, v, dt),
                                       KERNEL_NAMES["onehot_bwd"])[0])
        emit(rec)
        if not (rec["scaled_err"] <= TOL[dname] and rec["counts_exact"] and rec["dtype_ok"]):
            raise AssertionError(f"onehot_bwd edge case disagrees: {rec}")
    # accumulation into slices of a caller's buffers, as the collection does
    v, off = 3000, 500
    keys = torch.as_tensor(power_law(rng, v, (B, 6)).astype(np.int32), device=dev)
    d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev)
    base = torch.as_tensor(rng.standard_normal((off + v + 9, E), dtype=np.float32), device=dev)
    cbase = torch.arange(off + v + 9, dtype=torch.float32, device=dev)
    grad, cnt = base.clone(), cbase.clone()
    oh.onehot_matmul_bwd(keys, d, v, torch.float32, out=grad[off : off + v], cnt_out=cnt[off : off + v])
    wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32)
    sg, _ = oh.onehot_matmul_bwd_plain(keys, d.abs(), v, torch.float32)
    err = scaled_err(grad[off : off + v] - base[off : off + v], wg, sg + base[off : off + v].abs())
    untouched = bool(torch.equal(grad[:off], base[:off]) and torch.equal(grad[off + v :], base[off + v :]))
    cnt_ok = bool(torch.equal(cnt[off : off + v], cbase[off : off + v] + wc)
                  and torch.equal(cnt[:off], cbase[:off]))
    emit(dict(kernel="onehot_bwd", case="accumulate_into_slice", V=v, scaled_err=err,
              counts_exact=cnt_ok, rest_untouched=untouched))
    if not (err <= TOL["float32"] and cnt_ok and untouched):
        raise AssertionError("onehot_bwd accumulation into a caller's slice disagrees")


def segscan_checks(torch, np, rng, ss, dev, results):
    """segscan at the largest sorted-route K (table 21: 16384 x 27), then
    its edge cases and two runs compared bitwise."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    k = B * 27
    seg = np.sort(power_law(rng, 2_000_000, k))
    heads = torch.as_tensor(np.concatenate([[True], seg[1:] != seg[:-1]]), device=dev)
    for dt in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        dname = str(dt).split(".")[1]
        vals = torch.as_tensor(rng.standard_normal((k, E), dtype=np.float32), device=dev).to(dt)
        got = ss.segmented_sum_sorted(vals, heads)
        want = ss.segmented_sum_sorted_plain(vals, heads)
        scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
        torch.cuda.synchronize()
        isz = vals.element_size()
        b_ms, b_by = bound(2 * k * E * isz + k, k * E)
        dms, per_call = device_ms(lambda: ss.segmented_sum_sorted(vals, heads), KERNEL_NAMES["segscan"])
        repeat_equal = all(torch.equal(ss.segmented_sum_sorted(vals, heads), got) for _ in range(2))
        rec = dict(
            kernel="segscan", case="K442368", dtype=dname, K=k, E=E,
            segments=int(heads.sum()), scaled_err=scaled_err(got, want, scale),
            max_abs_err=float((got.float() - want.float()).abs().max()), tol=TOL[dname],
            bitwise_repeat=repeat_equal,
            ms=time_ms(lambda: ss.segmented_sum_sorted(vals, heads)),
            device_ms=dms, device_launches_per_call=per_call,
            plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads)),
            library_ms=None, library="none: no single PyTorch call computes a segmented scan",
            bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            seconds=time.perf_counter() - t0,
        )
        results.append(rec)
        emit(rec)
        if not (rec["scaled_err"] <= TOL[dname] and repeat_equal):
            raise AssertionError(f"segscan disagrees with its plain version: {rec}")
    t = ss.tile_rows()
    one_seg = np.zeros(k, bool)
    one_seg[0] = True
    cases = [("one_segment", one_seg), ("all_heads", np.ones(k, bool))]
    for kk in (t - 1, t + 1, 17, 0):
        seg = np.sort(rng.integers(0, max(kk // 3, 1), kk))
        cases.append((f"K{kk}", np.concatenate([[True], seg[1:] != seg[:-1]])[:kk]))
    for name, heads_np in cases:
        hd = torch.as_tensor(heads_np, device=dev)
        vals = torch.as_tensor(rng.standard_normal((len(heads_np), E), dtype=np.float32), device=dev)
        got = ss.segmented_sum_sorted(vals, hd)
        err = scaled_err(got, ss.segmented_sum_sorted_plain(vals, hd),
                         ss.segmented_sum_sorted_plain(vals.abs(), hd))
        rec = dict(kernel="segscan", case=name, K=len(heads_np), E=E, scaled_err=err,
                   tol=TOL["float32"], shape_ok=tuple(got.shape) == tuple(vals.shape),
                   bitwise_repeat=bool(torch.equal(ss.segmented_sum_sorted(vals, hd), got)))
        if len(heads_np) == k:
            rec["device_ms"] = device_ms(lambda: ss.segmented_sum_sorted(vals, hd), KERNEL_NAMES["segscan"])[0]
        emit(rec)
        if not (err <= TOL["float32"] and rec["shape_ok"] and rec["bitwise_repeat"]):
            raise AssertionError(f"segscan edge case disagrees: {rec}")


def tiny_parity(torch):
    """Phase 3: the port's tiny DLRM on the card (kernels) and on the CPU
    (plain versions) from the same state, 3 steps."""
    import numpy as np

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.carry import export_state, load_jax_state
    from hugectr_tpu_torch.tools.flagship import build_tiny_dlrm

    t0 = time.perf_counter()
    kw = dict(batchsize=64, onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0)
    gpu = build_tiny_dlrm(ResourceManager.create(), **kw)
    cpu = build_tiny_dlrm(ResourceManager.create(device="cpu"), **kw)
    load_jax_state(cpu, export_state(gpu))
    losses = [(gpu.train(), cpu.train()) for _ in range(3)]
    table_err = max(
        float(np.abs(gpu.tables[g].cpu().numpy() - cpu.tables[g].numpy()).max()) for g in gpu.tables
    )
    rec = dict(phase="tiny_parity", losses=losses, routes=dict(gpu.ec.group_routes),
               max_table_abs_err=table_err, seconds=time.perf_counter() - t0)
    emit(rec)
    for lg, lc in losses:
        if not abs(lg - lc) <= 1e-4 * abs(lc):
            raise AssertionError(f"tiny DLRM loss on the card {lg} != CPU {lc}")
    if not table_err <= 1e-5:
        raise AssertionError(f"tiny DLRM tables differ by {table_err}")


def main_path(torch):
    """Phase 4: the full-width flagship, 6 training steps."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import build_dlrm_dcnv2

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_dlrm_dcnv2(
        ResourceManager.create(), batchsize=B, ev_size=E, vocab_cap=2_000_000,
        synthetic_batches=6, optimizer="rowwise_adagrad",
    )
    model.start_data_reading()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ops.reset_counts()
    losses, step_s = [], []
    for _ in range(6):
        t = time.perf_counter()
        losses.append(model.train())
        step_s.append(time.perf_counter() - t)
    launches = ops.launch_counts()
    steady = statistics.median(step_s[1:])
    rec = dict(
        phase="main_path", tables=26, ev=E, batch=B, vocab_cap=2_000_000, steps=6,
        losses=losses, step_ms=[s * 1e3 for s in step_s], median_ms_per_step=steady * 1e3,
        examples_per_s=B / steady, max_memory_allocated=torch.cuda.max_memory_allocated(),
        routes=dict(model.ec.group_routes), route_counts=dict(model.ec.route_counts),
        launches=launches, build_seconds=build_s, seconds=time.perf_counter() - t0,
    )
    emit(rec)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss on the main path: {losses}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hugectr_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    card = card_line()
    _lib.library()
    ptxas = [ln.strip() for ln in _lib.build_info["log"].splitlines() if "Used" in ln or "spill" in ln]
    emit(dict(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
              nvcc_seconds=_lib.build_info["seconds"], ptxas=ptxas, seconds=time.perf_counter() - t0))

    results = []
    kernel_checks(torch, results)
    tiny_parity(torch)
    launches = main_path(torch)

    sources = {
        "onehot_fwd": ("hugectr_tpu_torch/csrc/onehot_matmul.cu",
                       "hugectr_tpu/ops/pallas/onehot_matmul.py:63"),
        "onehot_bwd": ("hugectr_tpu_torch/csrc/onehot_matmul.cu",
                       "hugectr_tpu/ops/pallas/onehot_matmul.py:118"),
        "segscan": ("hugectr_tpu_torch/csrc/segscan.cu", "hugectr_tpu/ops/pallas/segscan.py:58"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        # the float32 flagship case that costs the step most device time
        r = max((x for x in results if x["kernel"] == name and x["dtype"] == "float32"),
                key=lambda x: x["device_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], case=r["case"],
        ))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
