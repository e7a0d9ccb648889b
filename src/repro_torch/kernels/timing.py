"""Timing the port's kernels on the card, and their A/B between checkouts.

    python3 src/repro_torch/kernels/timing.py [--trees DIR ...] [--rounds R]
                                              [--kernels NAME ...]
                                              [--out PATH]
    python3 src/repro_torch/kernels/timing.py --trace-misses ROUNDS

Helpers that `chip_smoke.py` and `tests/test_torch_cuda.py` share:
`device_ms` (device time per call: a CUDA graph of many calls replayed
and timed with CUDA events), `eager_ms` (wall time per call as a host
loop pays it, launch included), `trace` (torch.profiler's records of
one call, with idle slack at both ends of the window) and `device_ops`
(the device operations one call makes, from `trace`).  `sim_calls`
gives the simulator's kernels at the kv_directory shapes of n agents
(nb = 2n bank rows of W=16 words, b_drain's m = 16n drained rows), with
their bytes and operations: `drain_writeback` under a packed mask and
under a bool mask (its REPRO_NO_PACK=1 instance, where the checkout has
it), `plane_commit`, and `trip_plan` without and with the remote
co-schedule, and each one's replica instance (`*_many`) at R = 2 and
64.  `serve_calls` gives the serving path's `rmsnorm` and
`topk_router` at granite-moe-1b-a400m's decode and prefill shapes, and
`train_calls` the training path's backward kernels `flash_attention_bwd`
and `rmsnorm_bwd` at chip_smoke.py phase 5's training shapes,
`dense_train_calls` the dense configs'
training instances (the backward at D=128 for each config in bf16 and
at qwen2.5-32b's heads in float32, with their forwards, and
`rmsnorm_bwd` at d = 5120 and 12288),
`decode_calls` `flash_decode` at granite's heads (its serving decode
shape, or any kv_len and cache length), and
`dense_calls` the dense configs' instances (attention and decode at
D=128, decode at GQA groups 1, 5 and 12, rmsnorm at d = 5120 and 12288)
at their serving shapes.

As a script it times those kernels, the simulator's at n=64 and n=256
(device ms, eager ms, device operations a call), a line each, then all
as one JSON line.
With `--trees`, it loads each checkout's `src/` apart in this one
process (`load_tree`: each keeps its own modules, kernel libraries and
`build/`) and times each kernel and shape in turns over the trees, in
the order given (parent, change, change, parent compares two versions
on one card), `--rounds` times over, then ends with each tree's medians
and, for two trees, how many parent/change pairs the change wins.
`--kernels` times only the kernels of those names.
One process and fine turns, because the host's speed, and so every
eager time, moves by half from one process, or one minute, to the next.
Only the kernel wrappers and the case generators come from the
checkout, so a checkout that predates this file works.
`--trace-misses` counts the traces that come back with no CUDA-side
record over ROUNDS rounds of chip_smoke.py phase 5's order, with no
slack in the window and with TRACE_SLACK_S.
This file imports nothing of the port at import time.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys


# the replica instances' replica counts in `sim_calls`
REPS = (2, 64)


def device_ms(fn, iters=50) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed and timed with CUDA events (host launch cost excluded);
    the median of 5 replays."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


def eager_ms(fn, iters=200) -> float:
    """Wall time per call as the main path pays it (launch included):
    `iters` calls back to back between two CUDA events, the median of 5
    such runs (the host's clock is noisier than the card's)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


TRACE_ATTEMPTS = 5
# idle time at each end of a trace's window: with none, now and then a
# short trace came back with the launch's CPU record and no CUDA-side one
# ("Activity Buffer Request" in it), and the next traces often missed too
# (`trace_misses` counts them)
TRACE_SLACK_S = 0.005


def trace(fn, attempts=TRACE_ATTEMPTS, slack_s=TRACE_SLACK_S,
          cpu=True) -> list:
    """torch.profiler's key_averages() (CPU and CUDA, or CUDA alone
    without `cpu`: no operator records, whose count makes a long run's
    trace slow to collect) of one call of `fn`,
    with `slack_s` seconds of idle time in the window before the call and
    after its synchronize.  A trace with no CUDA-side record is a tracer
    miss (a call that launches cannot make none) and is taken again, up
    to `attempts` times; the last one is returned all the same."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(slack_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(slack_s)
        recs = list(prof.key_averages())
        if any(e.device_type == DeviceType.CUDA for e in recs):
            break
    return recs


def device_ops(fn, attempts=TRACE_ATTEMPTS, slack_s=TRACE_SLACK_S) -> dict:
    """{record name: count} of the device operations one call of `fn`
    makes, from `trace`: every CUDA-side record (kernels, memsets,
    copies) and every cudaMemset* runtime call, so a memset counts as an
    operation however the tracer files it."""
    from torch.autograd import DeviceType
    ops = {}
    for e in trace(fn, attempts, slack_s):
        if e.device_type == DeviceType.CUDA \
                or e.key.startswith("cudaMemset"):
            ops[e.key] = ops.get(e.key, 0) + e.count
    return ops


def trace_misses(calls, rounds: int) -> dict:
    """{slack: {call: one-attempt traces with no CUDA-side record}} over
    `rounds` rounds of chip_smoke.py phase 5's order for each call (a
    trace with no slack and one with TRACE_SLACK_S, in turns, then CUDA
    graphs of the kernel and of its plain version, then an eager loop)."""
    from torch.autograd import DeviceType
    out = {0.0: {}, TRACE_SLACK_S: {}}
    for r in range(rounds):
        for call in calls:
            key = f"{call['name']} {call['shape']}"
            for slack in sorted(out, reverse=bool(r % 2)):
                miss = not any(
                    e.device_type == DeviceType.CUDA
                    for e in trace(call["fn"], attempts=1, slack_s=slack))
                out[slack][key] = out[slack].get(key, 0) + miss
            device_ms(call["fn"])
            device_ms(call["plain"])
            eager_ms(call["fn"], iters=20)
    return {str(k): v for k, v in out.items()}


def sim_calls(C, SF, FT, n: int, device, reps=REPS) -> list:
    """The simulator's kernels at the kv_directory shapes of n agents:
    [{name, shape, fn, plain, bytes, ops}], `fn` the kernel wrapper and
    `plain` its plain version on the same inputs (C, SF, FT: the
    `cases`, `selective_flush.ops` and `fused_turn.ops` modules); then,
    where the checkout has them, the replica instances (`*_many`) at
    each replica count in `reps`, R copies of those inputs moving R
    times the bytes."""
    import numpy as np
    nb, w, m = 2 * n, 16, 16 * n        # b_drain: n caches x fifo_cap

    def on(xs):
        return [C.to_torch(x).to(device) for x in xs]

    def solo(dw, dwb, pc, tp, tag=""):
        out = []
        # each bank word is read once (from l2 or from its owning row) and
        # written once, plus the packed mask and the index list
        out.append(dict(
            name=f"drain_writeback{tag}", shape=f"nb={nb} W={w} m={m}",
            fn=lambda: getattr(SF, f"drain_writeback{tag}")(*dw),
            plain=lambda: SF.drain_writeback_ref(*dw),
            bytes=4 * (2 * nb * w + m * dw[2].shape[-1] + m),
            ops=m * w + nb * w))
        if dwb is not None:
            out.append(dict(
                name=f"drain_writeback_bool{tag}",
                shape=f"nb={nb} W={w} m={m} bool",
                fn=lambda: getattr(SF, f"drain_writeback_bool{tag}")(*dwb),
                plain=lambda: SF.drain_writeback_ref(*dwb),
                # as above, with the mask as m*W bytes
                bytes=4 * (2 * nb * w + m) + m * w, ops=m * w + nb * w))
        words = n * nb * pc[0].shape[-1]
        out.append(dict(
            name=f"plane_commit{tag}",
            shape=f"n={n} nb={nb} L={pc[0].shape[-1]}",
            fn=lambda: getattr(FT, f"plane_commit{tag}")(*pc),
            plain=lambda: FT.plane_commit_ref(*pc),
            bytes=4 * 4 * words + n * (4 + 4 + 1 + 1) + 2 * n,
            ops=2 * words))
        plan = getattr(FT, f"trip_plan{tag}")
        out.append(dict(
            name=f"trip_plan{tag}", shape=f"n={n} remote_cap=False",
            fn=lambda: plan(*tp, None, remote_cap=False),
            plain=lambda: FT.trip_plan_ref(*tp[:4], None, None),
            bytes=n * (4 + 1 + 1 + 4) + 2 * n + 4, ops=16 * n))
        # with the remote co-schedule: raddr read, the n x n address dedup
        out.append(dict(
            name=f"trip_plan{tag}", shape=f"n={n} remote_cap=True",
            fn=lambda: plan(*tp, None, remote_cap=True),
            plain=lambda: FT.trip_plan_ref(*tp, None),
            bytes=n * (4 + 1 + 1 + 4 + 4) + 2 * n + 4,
            ops=16 * n + 4 * n * n))
        return out

    bool_ok = hasattr(SF, "drain_writeback_bool")
    ins = (C.dw_inputs(1, nb, w, m),
           C.dw_inputs(1, nb, w, m, bool_mask=True) if bool_ok else None,
           C.pc_inputs(1, n, nb, w), C.plan_inputs(1, n))
    out = solo(*(on(x) if x is not None else None for x in ins))
    if not hasattr(SF, "drain_writeback_many"):
        return out
    for r in reps:
        # every replica holds the solo inputs, so a replica row and its
        # solo row time the same data
        calls = solo(*(on([np.stack([a] * r) for a in x]) for x in ins),
                     "_many")
        for c in calls:
            c.update(shape=f"{c['shape']} R={r}", reps=r,
                     bytes=r * c["bytes"], ops=r * c["ops"])
        out += calls
    return out


# the serving shapes of granite-moe-1b-a400m (d=1024, E=32, top-8) on
# the engine of chip_smoke.py phase 7: 4 slots a decode step, a prompt
# of 256 tokens a prefill
SERVE_SHAPES = {"decode": 4, "prefill": 256}


def serve_calls(C, RN, TR, device) -> list:
    """The serving path's `rmsnorm` (x bf16 [1, rows, 1024] or
    [4, 1, 1024]) and `topk_router` (logits [T, 32] float32, k=8) at
    each of SERVE_SHAPES: [{name, shape, fn, plain, bytes, ops}] (C, RN,
    TR: the `cases`, `rmsnorm.ops` and `topk_router.ops` modules);
    `args` holds the inputs, for a library call beside the kernel."""
    out = []
    d, e, k = 1024, 32, 8
    for seed, (which, rows) in enumerate(SERVE_SHAPES.items()):
        shape = (rows, 1, d) if which == "decode" else (1, rows, d)
        x, w = C.rms_inputs(seed, shape)
        x = C.to_dtype(x, "bfloat16").to(device)
        w = C.to_dtype(w, "float32").to(device)
        out.append(dict(
            name="rmsnorm",
            shape=f"x [{','.join(map(str, shape))}] bf16 ({which})",
            fn=lambda x=x, w=w: RN.rmsnorm(x, w),
            plain=lambda x=x, w=w: RN.rmsnorm_ref(x, w),
            # x read and y written in bf16, w read in float32
            bytes=2 * 2 * rows * d + 4 * d, ops=3 * rows * d,
            args=(x, w)))
        logits = C.to_torch(C.router_inputs(seed, rows, e)).to(device)
        out.append(dict(
            name="topk_router", shape=f"logits [{rows},{e}] f32 k={k} "
                                      f"({which})",
            fn=lambda g=logits: TR.topk_router(g, k),
            plain=lambda g=logits: TR.topk_router_ref(g, k),
            # logits read; weights and indices written
            bytes=4 * rows * e + 8 * rows * k, ops=rows * e * (3 + k),
            args=(logits, k)))
    return out


# the training microbatch of chip_smoke.py phase 5 (granite-moe-1b-a400m,
# 4 sequences of 256 tokens, bf16): attention q [4, 16, 256, 64] against
# k/v [4, 8, 256, 64], rmsnorm x/dy [1024, 1024]
TRAIN_ATTN = dict(b=4, hq=16, hkv=8, s=256, d=64)
TRAIN_ROWS, TRAIN_D = 1024, 1024


def attn_bwd_call(C, FA, kw: dict, dtype: str, device, seed=9,
                  note="") -> dict:
    """`flash_attention_bwd` at shape `kw` in `dtype` (o and lse from the
    tree's own training forward), with its forward's call beside it:
    {name, shape, fn, plain, library, bytes, ops, fwd, fwd_plain,
    fwd_library, fwd_bytes, fwd_ops, kw}.  `library` is the backward through
    scaled_dot_product_attention (forward and backward, less the
    forward: autograd runs the backward on its forward's stream), used
    nowhere in the port; `ops` are the flops (the backward's 2.5 times the
    forward's causal matmul flops); the bytes each input is read once and
    each output written once."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    b, hq, hkv, s, d = (kw[k] for k in ("b", "hq", "hkv", "s", "d"))
    q, k, v = (C.to_dtype(x, dtype).to(device)
               for x in C.attn_inputs(seed, **kw))
    rng = np.random.default_rng(seed)
    do = C.to_dtype(rng.standard_normal(tuple(q.shape)).astype(np.float32),
                    dtype).to(device)
    o, lse = FA.flash_attention_lse(q, k, v)
    size = q.element_size()

    def sdpa(backward):
        ts = [t.detach().requires_grad_(backward) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*ts, is_causal=True,
                                             enable_gqa=True)
        if backward:
            torch.autograd.grad(out, ts, do)

    fwd_ops = 4 * d * b * hq * s * (s + 1) / 2
    return dict(
        name="flash_attention_bwd",
        shape=f"q [{b},{hq},{s},{d}] k/v [{b},{hkv},{s},{d}] "
              f"{'bf16' if dtype == 'bfloat16' else dtype}{note}",
        fn=lambda: FA.flash_attention_bwd(q, k, v, o, do, lse),
        plain=lambda: FA.flash_attention_bwd_ref(q, k, v, o, do, lse),
        library=lambda: device_ms(lambda: sdpa(True))
        - device_ms(lambda: sdpa(False)),
        # q, k, v, o, dO and lse in; dQ, dK, dV out
        bytes=size * d * s * b * (4 * hq + 4 * hkv) + 4 * b * hq * s,
        ops=2.5 * fwd_ops,
        fwd=lambda: FA.flash_attention_lse(q, k, v),
        fwd_plain=lambda: FA.flash_attention_lse_ref(q, k, v),
        fwd_library=lambda: device_ms(lambda: sdpa(False)),
        # q, k, v in; o and lse out
        fwd_bytes=size * d * s * b * (2 * hq + 2 * hkv) + 4 * b * hq * s,
        fwd_ops=fwd_ops, kw=kw)


def rms_bwd_call(C, RN, rows: int, dm: int, device, seed=9,
                 note="") -> dict:
    """`rmsnorm_bwd` on bf16 x/dy [rows, dm], float32 w: {name, shape, fn,
    plain, library, bytes, ops}, `library` the backward of F.rms_norm
    (bf16 weight: it takes the weight in x's type), timed as forward and
    backward less the forward."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    x, w = C.rms_inputs(seed, (rows, dm))
    x = C.to_dtype(x, "bfloat16").to(device)
    w = C.to_dtype(w, "float32").to(device)
    rng = np.random.default_rng(seed)
    dy = C.to_dtype(rng.standard_normal(tuple(x.shape)).astype(np.float32),
                    "bfloat16").to(device)
    w_bf = w.to(torch.bfloat16)

    def rms(backward):
        xr, wr = (t.detach().requires_grad_(backward) for t in (x, w_bf))
        out = F.rms_norm(xr, (dm,), wr, 1e-6)
        if backward:
            torch.autograd.grad(out, (xr, wr), dy)

    return dict(name="rmsnorm_bwd", shape=f"x/dy [{rows},{dm}] bf16{note}",
                fn=lambda: RN.rmsnorm_bwd(x, w, dy),
                plain=lambda: RN.rmsnorm_bwd_ref(x, w, dy),
                library=lambda: device_ms(lambda: rms(True))
                - device_ms(lambda: rms(False)),
                bytes=3 * 2 * rows * dm + 8 * dm, ops=10 * rows * dm)


def train_calls(C, FA, RN, device) -> list:
    """The training path's backward kernels at TRAIN_ATTN and [TRAIN_ROWS,
    TRAIN_D], bf16: `flash_attention_bwd` and `rmsnorm_bwd`
    (`attn_bwd_call`, `rms_bwd_call`; C, FA, RN: the `cases`,
    `flash_attention.ops` and `rmsnorm.ops` modules)."""
    return [attn_bwd_call(C, FA, TRAIN_ATTN, "bfloat16", device),
            rms_bwd_call(C, RN, TRAIN_ROWS, TRAIN_D, device)]


# the dense configs' training microbatch (chip_smoke.py phases 5 and 11:
# 4 sequences of 256 tokens), per config (name, Hq, Hkv) at D=128, and
# rmsnorm's rows at their widths
DENSE_TRAIN_ATTN = dict(b=4, s=256, d=128)
DENSE_TRAIN_HEADS = (("qwen2.5-32b", 40, 8), ("qwen1.5-32b", 40, 40),
                     ("mistral-large-123b", 96, 8))


def dense_train_calls(C, FA, RN, device) -> list:
    """The dense configs' training instances: `flash_attention_bwd` at
    D=128 in bf16 for each config of DENSE_TRAIN_HEADS and in float32 at
    qwen2.5-32b's heads, and `rmsnorm_bwd` at DENSE_RMS_D over a
    microbatch's TRAIN_ROWS rows (`attn_bwd_call`, `rms_bwd_call`; each
    attention call carries its forward, `flash_attention_lse`)."""
    out = []
    for seed, (cfg, hq, hkv) in enumerate(DENSE_TRAIN_HEADS):
        out.append(dict(attn_bwd_call(C, FA, dict(DENSE_TRAIN_ATTN, hq=hq,
                                                  hkv=hkv), "bfloat16",
                                      device, seed=60 + seed,
                                      note=f" ({cfg})"), config=cfg))
    cfg, hq, hkv = DENSE_TRAIN_HEADS[0]
    out.append(dict(attn_bwd_call(C, FA, dict(DENSE_TRAIN_ATTN, hq=hq,
                                              hkv=hkv), "float32", device,
                                  seed=63, note=f" ({cfg})"), config=cfg))
    for seed, dm in enumerate(DENSE_RMS_D):
        out.append(rms_bwd_call(C, RN, TRAIN_ROWS, dm, device,
                                seed=70 + seed))
    return out


# the dense configs' serving shapes (chip_smoke.py phases 5 and 10),
# bf16: qwen2.5-32b's prefill of 256 tokens (40/8 heads, D=128), decode
# at 8 slots over full 512-position caches for groups 5 (qwen2.5-32b,
# 40/8), 1 (qwen1.5-32b, 40/40) and 12 (mistral-large-123b, 96/8), and
# rmsnorm over the 8 slots' rows at d = 5120 and 12288
DENSE_PREFILL = dict(b=1, hq=40, hkv=8, s=256, d=128)
DENSE_DECODE = {"qwen2.5-32b": (40, 8), "qwen1.5-32b": (40, 40),
                "mistral-large-123b": (96, 8)}
DENSE_SLOTS, DENSE_MAX_LEN = 8, 512
DENSE_RMS_D = (5120, 12288)


def dense_calls(C, FA, FD, RN, device) -> list:
    """The dense configs' instances of the serving kernels at their
    bfloat16 serving shapes: `flash_attention` at D=128 (DENSE_PREFILL),
    `flash_decode` at D=128 for each config of DENSE_DECODE (B =
    DENSE_SLOTS, every row's kv_len DENSE_MAX_LEN) and `rmsnorm` at
    DENSE_RMS_D: [{name, shape, fn, plain, library, bytes, ops}] (C, FA,
    FD, RN: the `cases`, `flash_attention.ops`, `flash_decode.ops` and
    `rmsnorm.ops` modules).  `library` is one PyTorch call of the same
    function (scaled_dot_product_attention, F.rms_norm), timed beside the
    kernel and used nowhere in the port; `ops` are flops (bf16 tensor
    cores for attention)."""
    import torch
    import torch.nn.functional as F
    out = []
    kw = DENSE_PREFILL
    b, hq, hkv, s, d = (kw[k] for k in ("b", "hq", "hkv", "s", "d"))
    q, k, v = (C.to_dtype(x, "bfloat16").to(device)
               for x in C.attn_inputs(21, **kw))
    out.append(dict(
        name="flash_attention",
        shape=f"q [{b},{hq},{s},{d}] k/v [{b},{hkv},{s},{d}] bf16 causal "
              f"(qwen2.5-32b prefill)",
        fn=lambda: FA.flash_attention(q, k, v),
        plain=lambda: FA.flash_attention_ref(q, k, v),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        # q, k, v read and o written once; 4 D flops a visible pair
        bytes=2 * d * b * s * (2 * hq + 2 * hkv),
        ops=4 * d * b * hq * s * (s + 1) / 2))
    bs, sl = DENSE_SLOTS, DENSE_MAX_LEN
    for seed, (cfg, (hq, hkv)) in enumerate(DENSE_DECODE.items()):
        qd, kc, vc, _ = C.decode_inputs(30 + seed, bs, hq, hkv, sl, 128)
        qd, kc, vc = (C.to_dtype(x, "bfloat16").to(device)
                      for x in (qd, kc, vc))
        lens = torch.full((bs,), sl, dtype=torch.int32, device=device)
        mask = torch.ones((bs, 1, 1, sl), dtype=torch.bool, device=device)
        out.append(dict(
            name="flash_decode",
            shape=f"q [{bs},{hq},128] cache [{bs},{hkv},{sl},128] bf16 "
                  f"group {hq // hkv} kv_len {sl} ({cfg} decode)",
            fn=lambda qd=qd, kc=kc, vc=vc, lens=lens: FD.flash_decode(
                qd, kc, vc, lens),
            plain=lambda qd=qd, kc=kc, vc=vc, lens=lens: FD.flash_decode_ref(
                qd, kc, vc, lens),
            library=lambda qd=qd, kc=kc, vc=vc, mask=mask:
                F.scaled_dot_product_attention(qd[:, :, None], kc, vc,
                                               attn_mask=mask,
                                               enable_gqa=True),
            # the valid prefix of K and V read once, q read, out written
            bytes=2 * 2 * 128 * hkv * bs * sl + 2 * 2 * bs * hq * 128
            + 4 * bs,
            ops=4 * hq * 128 * bs * sl, hq=hq, hkv=hkv))
    for seed, dm in enumerate(DENSE_RMS_D):
        x, w = C.rms_inputs(40 + seed, (bs, 1, dm))
        x = C.to_dtype(x, "bfloat16").to(device)
        w = C.to_dtype(w, "float32").to(device)
        w_bf = w.to(torch.bfloat16)   # F.rms_norm takes the weight in x's type
        out.append(dict(
            name="rmsnorm", shape=f"x [{bs},1,{dm}] bf16 (decode)",
            fn=lambda x=x, w=w: RN.rmsnorm(x, w),
            plain=lambda x=x, w=w: RN.rmsnorm_ref(x, w),
            library=lambda x=x, w_bf=w_bf: F.rms_norm(x, (x.shape[-1],),
                                                      w_bf, 1e-6),
            bytes=2 * 2 * bs * dm + 4 * dm, ops=3 * bs * dm))
    return out


# granite-moe-1b-a400m's decode on the engine of chip_smoke.py phase 7
# (4 slots over 512-position caches, 16/8 heads, D=64, bf16), each slot's
# kv_len its prompt's length (phase 7's first four: 256, 16, 38, 67) plus
# half its 32 new tokens: the shape of chip_smoke.py phase 5's decode,
# which takes its entry from `decode_calls` and raises if phase 7's
# prompts give other lengths
GRANITE_DECODE_LENS = (272, 32, 54, 83)
# granite's heads over full 4,096-position caches: each rank's share is
# 512 rows, eight 64-row chunks of the tensor-core instance (its second
# pass reloads K and V), where the serving shape's shares fit one chunk
GRANITE_LONG_LENS, GRANITE_LONG_S = (4096,) * 4, 4096


def decode_calls(C, FD, device, lens=GRANITE_DECODE_LENS, s=512,
                 what="granite decode") -> list:
    """`flash_decode` at granite-moe-1b-a400m's heads (16/8, D=64, bf16),
    one slot a kv_len of `lens` over `s`-position caches (by default the
    serving decode shape, GRANITE_DECODE_LENS): [{name, shape, fn, plain,
    library, bytes, ops}] (C, FD: the `cases` and `flash_decode.ops`
    modules)."""
    import torch
    import torch.nn.functional as F
    b, hq, hkv, d = len(lens), 16, 8, 64
    qd, kc, vc, _ = C.decode_inputs(35, b, hq, hkv, s, d)
    qd, kc, vc = (C.to_dtype(x, "bfloat16").to(device) for x in (qd, kc, vc))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    mask = (torch.arange(s, device=device) < kv_len[:, None])[:, None, None, :]
    valid = sum(lens)
    return [dict(
        name="flash_decode",
        shape=f"q [{b},{hq},{d}] cache [{b},{hkv},{s},{d}] bf16 kv_len "
              f"{list(lens)} ({what})",
        fn=lambda: FD.flash_decode(qd, kc, vc, kv_len),
        plain=lambda: FD.flash_decode_ref(qd, kc, vc, kv_len),
        library=lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
        # the valid prefix of K and V read once, q read, out written
        bytes=2 * 2 * d * hkv * valid + 2 * 2 * b * hq * d + 4 * b,
        ops=4 * hq * d * valid)]


SIM_NS = (64, 256)
# the kernels whose call is one device operation, by the name of their
# __global__ function in torch.profiler's records (the replica instances
# launch the solo kernels' __global__ functions)
ONE_OP = {"drain_writeback": "drain_writeback_kernel",
          "drain_writeback_bool": "drain_writeback_kernel",
          "plane_commit": "plane_commit_kernel",
          "trip_plan": "trip_plan_kernel",
          "drain_writeback_many": "drain_writeback_kernel",
          "drain_writeback_bool_many": "drain_writeback_kernel",
          "plane_commit_many": "plane_commit_kernel",
          "trip_plan_many": "trip_plan_kernel",
          "rmsnorm": "rmsnorm_rows_kernel",
          "topk_router": "topk_router_kernel"}
SERVE_KERNELS = ("rmsnorm", "topk_router")


def load_tree(src: str) -> tuple:
    """(cases, selective_flush.ops, fused_turn.ops, rmsnorm.ops,
    topk_router.ops, flash_attention.ops, flash_decode.ops) of the port
    under `src`,
    imported apart from any
    tree loaded before: the modules of the earlier tree leave
    `sys.modules` first, and keep the modules they imported, so trees
    loaded in turn coexist in one process."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(src))
    try:
        return tuple(importlib.import_module(f"repro_torch.kernels.{m}")
                     for m in ("cases", "selective_flush.ops",
                               "fused_turn.ops", "rmsnorm.ops",
                               "topk_router.ops", "flash_attention.ops",
                               "flash_decode.ops"))
    finally:
        sys.path.pop(0)


def time_trees(trees: list, rounds: int, kernels=None) -> list:
    """Device and eager ms per call of the simulator's kernels at n in
    SIM_NS, of the serving kernels at SERVE_SHAPES (`serve_calls`), of
    the training backward kernels (`train_calls`), of granite's decode
    at its serving shape and over GRANITE_LONG_S-position caches
    (`decode_calls`) and of the dense configs' instances (`dense_calls`),
    or of those named
    in `kernels`, for each checkout in `trees` (`load_tree`; a path may
    repeat), interleaved: each kernel and shape is timed `rounds` times
    over the list of trees before the next, so the host's drift falls on
    every tree alike.  One record a measurement; the device operations a
    call makes (`device_ops`) are taken after every timing."""
    import torch
    calls = {}
    for tree in trees:
        key = os.path.abspath(tree)
        if key not in calls:
            C, SF, FT, RN, TR, FA, FD = load_tree(os.path.join(tree, "src"))
            dev = torch.device("cuda")
            calls[key] = {(c["name"], c["shape"]): dict(c, n=n)
                          for n in SIM_NS
                          for c in sim_calls(C, SF, FT, n, dev)}
            # a tree before the D=128 instances has no dense calls, one
            # before the D=128 backward none of its training ones
            dense = dense_calls(C, FA, FD, RN, dev) \
                if 128 in getattr(FA, "HEAD_DIMS", ()) else []
            if 128 in getattr(FA, "BWD_HEAD_DIMS", ()):
                dense += dense_train_calls(C, FA, RN, dev)
            calls[key].update({(c["name"], c["shape"]): dict(c, n=None)
                               for c in serve_calls(C, RN, TR, dev)
                               + train_calls(C, FA, RN, dev)
                               + decode_calls(C, FD, dev)
                               + decode_calls(C, FD, dev, GRANITE_LONG_LENS,
                                              GRANITE_LONG_S,
                                              "granite heads, long cache")
                               + dense})
            if kernels:
                calls[key] = {k: c for k, c in calls[key].items()
                              if c["name"] in kernels}
    kinds = list(dict.fromkeys(k for per in calls.values() for k in per))
    recs = []
    for kind in kinds:
        for _ in range(rounds):
            for tree in trees:
                call = calls[os.path.abspath(tree)].get(kind)
                if call is None:          # an older tree lacks this kernel
                    continue
                rec = {"tree": tree, "name": call["name"], "n": call["n"],
                       "shape": call["shape"], "ms": device_ms(call["fn"]),
                       "eager_ms": eager_ms(call["fn"])}
                recs.append(rec)
                print(f"{tree}: {rec['name']} {rec['shape']}: "
                      f"{rec['ms']:.7f} ms, eager {rec['eager_ms']:.7f} ms",
                      flush=True)
    # traced last: once torch.profiler has run in a process, every later
    # device time reads higher
    ops = {}
    for rec in recs:
        key = (rec["tree"], rec["name"], rec["shape"])
        if key not in ops:
            call = calls[os.path.abspath(rec["tree"])][key[1:]]
            ops[key] = sum(device_ops(call["fn"]).values())
            print(f"{rec['tree']}: {rec['name']} {rec['shape']}: "
                  f"{ops[key]} device ops a call", flush=True)
        rec["ops_per_call"] = ops[key]
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="*", default=None,
                    help="checkouts to time, in turns, in this order "
                         "(default: this one)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time the list of trees this many times over")
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="time only the kernels of these names")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-misses", type=int, default=0, metavar="ROUNDS",
                    help="count torch.profiler's empty traces over ROUNDS "
                         "rounds of phase 5's order at n=64, then exit")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if args.trace_misses:
        calls = sim_calls(*load_tree(os.path.join(here, "..", ".."))[:3],
                          64, torch.device("cuda"))
        print(json.dumps({"rounds": args.trace_misses, "misses_by_slack_s":
                          trace_misses(calls, args.trace_misses)}))
        return 0
    trees = args.trees or [os.path.abspath(os.path.join(here, "..", "..",
                                                        ".."))]
    recs = time_trees(trees, args.rounds, args.kernels)
    medians = tree_medians(recs)
    for m in medians:
        print(f"median of {m['runs']} runs, {m['tree']}: {m['name']} "
              f"{m['shape']}: {m['ms']:.7f} ms, eager {m['eager_ms']:.7f} ms",
              flush=True)
    pairs = pair_wins(recs)
    for m in pairs:
        print(f"pairs, {m['name']} {m['shape']}: {m['tree']} under "
              f"{m['base']} in {m['ms_wins']}/{m['pairs']} (device), "
              f"{m['eager_wins']}/{m['pairs']} (eager); {m['base']}'s "
              f"interquartile range {m['base_ms_iqr']:.7f} ms, eager "
              f"{m['base_eager_iqr']:.7f} ms", flush=True)
    doc = {"records": recs, "medians": medians, "pairs": pairs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    return 0


def tree_medians(recs: list) -> list:
    """Per tree, kernel and shape: the median device and eager ms over
    that tree's records (the upper median of an even count)."""
    by = {}
    for r in recs:
        by.setdefault((r["tree"], r["name"], r["shape"]), []).append(r)
    out = []
    for (tree, name, shape), recs in by.items():
        ms, eager = (sorted(r[k] for r in recs)[len(recs) // 2]
                     for k in ("ms", "eager_ms"))
        out.append({"tree": tree, "name": name, "shape": shape,
                    "runs": len(recs), "ms": ms, "eager_ms": eager})
    return out


def _quartiles(xs: list) -> tuple:
    xs = sorted(xs)
    return xs[len(xs) // 4], xs[(3 * len(xs)) // 4]


def pair_wins(recs: list) -> list:
    """With two trees (the first named is the base): per kernel and shape,
    the records taken one after another paired in turn (parent, change,
    change, parent gives two pairs a round); how many pairs the other
    tree wins on device and on eager time (a tie counts for neither), and
    the interquartile range of the base's own runs."""
    trees = list(dict.fromkeys(r["tree"] for r in recs))
    if len(trees) != 2:
        return []
    base, other = trees
    by = {}
    for r in recs:
        by.setdefault((r["name"], r["shape"]), []).append(r)
    out = []
    for (name, shape), rs in by.items():
        pairs = [(a, b) if a["tree"] == base else (b, a)
                 for a, b in zip(rs[::2], rs[1::2]) if a["tree"] != b["tree"]]
        mine = [r for r in rs if r["tree"] == base]
        if not mine:                      # a kernel the base lacks
            continue
        iqr = {k: (lambda q: q[1] - q[0])(_quartiles([r[k] for r in mine]))
               for k in ("ms", "eager_ms")}
        out.append({"name": name, "shape": shape, "base": base,
                    "tree": other, "pairs": len(pairs),
                    "ms_wins": sum(c["ms"] < p["ms"] for p, c in pairs),
                    "eager_wins": sum(c["eager_ms"] < p["eager_ms"]
                                      for p, c in pairs),
                    "base_ms_iqr": iqr["ms"],
                    "base_eager_iqr": iqr["eager_ms"]})
    return out


if __name__ == "__main__":
    # run as a file: keep this directory's modules off the import path
    if os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.exit(main())
