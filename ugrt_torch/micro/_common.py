"""Shared pieces of the probes: the card check, CUDA-event timing and
the comparison of a kernel's outputs with its plain version's."""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """The CUDA device; raises if there is none (the probes time the
    card and have no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the ugrt_torch.micro probes need an NVIDIA GPU: "
                           "CUDA is not available")
    return torch.device("cuda")


def main_device() -> torch.device:
    """``require_cuda()`` for a module's ``main``: without a card it
    exits non-zero with the same message, and nothing runs on the CPU."""
    try:
        return require_cuda()
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean CUDA-event ms of fn() over ``iters`` back-to-back calls, after
    one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want) -> tuple[int, float]:
    """(elements whose bits differ, max |difference| over finite pairs)
    of two tuples of equally shaped tensors."""
    mism, err = 0, 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            mism += int((g.view(torch.int32) != w.view(torch.int32)).sum())
        else:
            mism += int((g != w).sum())
        d = (g.double() - w.double()).abs()
        d = d[torch.isfinite(d)]
        if d.numel():
            err = max(err, float(d.max()))
    return mism, err


def record(kernel, variant, mismatches, max_abs_err, ms, plain_ms, **extra):
    """One probe result, as the probes return and print it."""
    return dict(kernel=kernel, variant=variant, mismatches=mismatches,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, **extra)


def print_records(title, records):
    print(f"{title} on {card_line()}", flush=True)
    for r in records:
        extra = "".join(f", {k} {v}" for k, v in r.items()
                        if k not in ("kernel", "variant", "mismatches",
                                     "max_abs_err", "ms", "plain_ms"))
        print(f"  {r['kernel']} {r['variant']}: {r['mismatches']} "
              f"mismatches, max |diff| {r['max_abs_err']}{extra}; "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms)", flush=True)
