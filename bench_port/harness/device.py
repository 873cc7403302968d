"""The card's clocks and counters as the kinds use them, with the CPU
standing in (no memory counter, no events) where the tests drive a run
without a card."""

from __future__ import annotations

import torch


def on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def synchronize(device) -> None:
    if on_cuda(device):
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if on_cuda(device) else 0


def reset_peak(device) -> None:
    if on_cuda(device):
        torch.cuda.reset_peak_memory_stats()


def empty_cache(device) -> None:
    if on_cuda(device):
        torch.cuda.empty_cache()
