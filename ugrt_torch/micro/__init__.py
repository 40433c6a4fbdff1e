"""The scripts of ``scripts/`` that the port keeps: the TPU probes S1-S3
as Hopper kernel probes, and the reflective-frame bench.

Each probe is named after the script it ports and runs on an NVIDIA
GPU only (there is no CPU fallback): it makes the script's workload from
its seeds with numpy, at the script's sizes, holds every kernel variant
against its plain PyTorch version, then prints CUDA-event ms per variant.

    python -m ugrt_torch.micro.micro_mxu      # S1: tensor vs CUDA cores
    python -m ugrt_torch.micro.pallas_micro   # S2: copy vs math
    python -m ugrt_torch.micro.micro_heavy    # S3: window-loop layouts

``bench_reflective`` is scripts/bench_reflective.py (BASELINE config 4),
and ``_timing`` the part of scripts/_timing.py that it and
``ugrt_torch.bench`` use.

    python -m ugrt_torch.micro.bench_reflective
"""
