"""Model FLOPs of every prompt and output token completed in the traced
window (``work.ModelFlops``), over the window's seconds times the card's
published bf16 peak, in %; nothing where no device was traced."""


def read(r):
    if not r["model_flops"] or not r["busy_s"]:
        return None
    return 100.0 * r["model_flops"] / (r["window_s"] * r["peak_flops"])
