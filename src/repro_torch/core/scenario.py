"""The serving scenario of the cost model: the port's copy of the
``Scenario`` dataclass of ``repro.core.optimizer``, alone (the search and
selection of that module stay in the NumPy reference)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Scenario:
    """TPOT SLO x average context length (paper section 3.1), optionally
    extended with a prefill spec: `prompt_len` (tokens to prefill per
    request) and `ttft_ms` (time-to-first-token SLO; 0 = unconstrained).
    `prompt_len == 0` keeps the seed's decode-only semantics.

    The routing axis models expert-load skew: `routing="zipf"` with
    `zipf_s > 0` draws a per-MoE-layer Zipf(s) expert-popularity vector
    from `routing_seed` (`core.placement`), and the cost model charges the
    MAX per-rank expert load instead of the mean. The default
    (`routing="uniform"`, which `zipf_s=0` also reduces to) is
    byte-identical to the pre-skew stack — `name` and every sweep result
    are unchanged."""
    tpot_ms: float
    context: int
    prompt_len: int = 0
    ttft_ms: float = 0.0
    routing: str = "uniform"
    zipf_s: float = 0.0
    routing_seed: int = 0

    def __post_init__(self):
        if self.routing not in ("uniform", "zipf"):
            raise ValueError(f"unknown routing {self.routing!r}; "
                             "expected 'uniform' or 'zipf'")
        if self.zipf_s < 0:
            raise ValueError(f"zipf_s must be >= 0, got {self.zipf_s}")

    @property
    def is_skewed(self) -> bool:
        """True when the scenario departs from uniform expert load —
        s = 0 is the uniform distribution, so it keeps the fast path."""
        return self.routing == "zipf" and self.zipf_s > 0

    @property
    def name(self) -> str:
        base = f"tpot{int(self.tpot_ms)}ms_ctx{self.context}"
        if self.prompt_len:
            base += f"_p{self.prompt_len}_ttft{int(self.ttft_ms)}ms"
        if self.is_skewed:
            base += f"_zipf{self.zipf_s:g}"
            if self.routing_seed:
                base += f"_seed{self.routing_seed}"
        return base

    @property
    def gen_len(self) -> int:
        """Decode tokens per request implied by `context` being the AVERAGE
        KV length during decode: context = prompt_len + gen_len / 2."""
        return max(2 * (self.context - self.prompt_len), 1)

    @property
    def mem_context(self) -> int:
        """Context of the single-request KV REJECTION guard: a scenario is
        serveable only if one request's prompt plus its decode context can
        be held at all. Batch sizing itself stays at the seed convention
        (KV at the AVERAGE `context`); the in-flight prompt KV of chunked
        prefill (at most one request per DP domain) is second-order
        against the hundreds of decode slots per device and is not
        reserved per slot."""
        return self.context + self.prompt_len
