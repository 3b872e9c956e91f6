"""Summed roofline bound of the needed work of every ``moe_gmm`` call in
the traced window (``work.moe_gmm_work``, read at each call) over the
summed profiler time of its kernels, in %."""


def read(r):
    m = r["moe_gmm"]
    if not m["calls"] or not m["kernel_s"]:
        return None
    return 100.0 * m["bound_s"] / m["kernel_s"]
