"""The scripts of ``scripts/`` that the port keeps: the TPU probes S1-S3
as Hopper kernel probes, the reflective-frame bench and the profiling
scripts.

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

The profiling scripts, on the card at the flagship (``parse_trace`` reads
a file anywhere):

    python -m ugrt_torch.micro.profile_chain          # line-item profile
    python -m ugrt_torch.micro.capture_trace --out DIR [--pi-extent]
    python -m ugrt_torch.micro.parse_trace DIR [top_n]  # device-op table
    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m ugrt_torch.micro.trace_psum_overlap --out DIR
    python -m ugrt_torch.micro.render_samples --out DIR   # sample PNGs

``k3_chunks`` times one sweep kernel on the flagship frame's inputs
against another tree's, and ``dda_edge`` is D1's edge case.
"""
