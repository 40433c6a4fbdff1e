"""The TPU probes S1-S3 of ``scripts/`` as Hopper kernel probes.

Each module is named after the script it ports and runs on an NVIDIA
GPU only (there is no CPU fallback): it makes the script's workload from
its seeds with numpy, at the script's sizes, holds every kernel variant
against its plain PyTorch version, then prints CUDA-event ms per variant.

    python -m ugrt_torch.micro.micro_mxu      # S1: tensor vs CUDA cores
    python -m ugrt_torch.micro.pallas_micro   # S2: copy vs math
    python -m ugrt_torch.micro.micro_heavy    # S3: window-loop layouts
"""
