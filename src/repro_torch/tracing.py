"""Spans and counters of the serving path, for a profiler to read.

``span(name)`` opens a ``torch.profiler.record_function`` span named
`name` when a profiler is recording, and a shared do-nothing context
otherwise: an ungated ``record_function`` costs about 10 us of host time
even with no profiler running, the gated no-op about 0.5 us (the host of
an H100 server), and a decode wave opens tens of spans. A span lands in the
profiler's own trace beside the device's kernels, copies and sets, on the
trace's clock; it keeps no timestamps of its own, and reads nothing on
the device. Every name is in ``SPANS``; ``span`` takes no other.

The spans, by module (prefill and decode share the layer names; the
enclosing ``serve.prefill`` or ``serve.wave`` tells them apart):

- ``serving/engine.py``: ``serve.step`` (``Engine.step``), ``serve.admit``
  (the admission loop), ``serve.prefill`` (one request's prefill, the
  padding to capacity included), ``serve.insert`` (the copy into the
  slot), ``serve.wave`` (the decode step), ``serve.readback`` (the host
  waiting for the wave's tokens), ``serve.retire`` (the token and
  retire loop after it);
- ``models/model.py``: ``lm.embed``, ``lm.head`` (final norm, logits,
  greedy sample);
- ``layers/mla.py``: ``mla.project`` (projections and the cache write),
  ``mla.decompress`` (K and V from the latent), ``mla.attend``,
  ``mla.out``; ``layers/attention.py``: ``attn`` (a GQA mixer);
  ``layers/mamba.py``: ``mamba.project`` (in projections, conv, gates),
  ``mamba.scan`` (the chunked scan, or decode's one-step update and its
  cache write), ``mamba.out``;
- ``layers/moe.py``: ``moe.route`` (router, top-k, slot assignment),
  ``moe.dispatch`` (the scatter and the dispatch all-to-all started),
  ``moe.experts`` (its wait, ``moe_gmm``, the combine started),
  ``moe.combine`` (its wait, the gather, the gates), ``moe.shared``;
  ``models/transformer.py``: ``ffn.dense``.

The profiler exports no argument of a ``record_function`` span, so no
span carries a request id: a request's prefill is the n-th
``serve.prefill`` of its step, in the order of admission.

``count(name, n)`` adds to a host integer, one of ``COUNTERS``, which the
engine counts whether or not a profiler records: ``serve.prefill_tokens``,
the prompt tokens prefilled, which turns a prefill span's device time
into a cost per token. ``counters()`` is a snapshot of it and of the
kernel wrappers' own launch counts (``kernels/moe_gmm.py``,
``kernels/flash_decode.py``); ``reset()`` zeroes all of them.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import moe_gmm as kmoe

SPANS = frozenset({
    "serve.step", "serve.admit", "serve.prefill", "serve.insert", "serve.wave",
    "serve.readback", "serve.retire",
    "lm.embed", "lm.head",
    "mla.project", "mla.decompress", "mla.attend", "mla.out",
    "attn",
    "mamba.project", "mamba.scan", "mamba.out",
    "moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared",
    "ffn.dense",
})
COUNTERS = frozenset({"serve.prefill_tokens"})

_OFF = contextlib.nullcontext()
_counts = dict.fromkeys(COUNTERS, 0)


def span(name: str):
    """A context that records the span `name` while a profiler records,
    and does nothing otherwise."""
    if name not in SPANS:
        raise ValueError(f"{name!r} is not a span of repro_torch.tracing.SPANS")
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    if name not in COUNTERS:
        raise ValueError(f"{name!r} is not a counter of repro_torch.tracing.COUNTERS")
    _counts[name] += n


def counters() -> dict:
    """A snapshot of every counter, the kernel wrappers' launches included
    (forward launches, in this process)."""
    out = dict(_counts)
    out["moe_gmm.launches"] = kmoe.launches
    for variant, n in kmoe.variant_launches.items():
        out[f"moe_gmm.launches.{variant}"] = n
    out["flash_decode.launches"] = kfd.launches
    out["flash_decode_lse.launches"] = kfd.lse_launches
    return out


def reset() -> None:
    """Zero every counter, the kernel wrappers' included (``moe_gmm``'s
    skip counters on the cards too, queued)."""
    for name in _counts:
        _counts[name] = 0
    kmoe.reset_counts()
    kfd.launches = kfd.lse_launches = 0
