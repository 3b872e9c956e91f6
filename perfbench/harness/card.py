"""The card a one-chip cell runs on, and what a run reads of it."""
from __future__ import annotations

import torch

DEVICE = torch.device("cuda", 0)


def sync():
    torch.cuda.synchronize(DEVICE)


def peak_bytes() -> int:
    return int(torch.cuda.max_memory_allocated(DEVICE))


def name() -> str:
    return torch.cuda.get_device_name(DEVICE)


def release():
    torch.cuda.empty_cache()


def profiler():
    """The profiler of a traced window: host operations and the card's."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
