"""Summed roofline bound of the needed work of every ``flash_decode``
call in the traced window (``work.flash_decode_work``: the K and V rows
below each length, q and o, once) over the summed profiler time of its
kernels, in %."""


def read(r):
    m = r["flash_decode"]
    if not m["calls"] or not m["kernel_s"]:
        return None
    return 100.0 * m["bound_s"] / m["kernel_s"]
