"""Median host-clock ms of the engine steps that admitted a request
(prefills, then the decode wave); ``Engine.step`` ends in a read-back, so
its end waits for the device."""
import statistics


def read(r):
    ms = [(ta - tb) * 1e3 for tb, ta, admitted in r["steps"] if admitted > 0]
    return statistics.median(ms) if ms else None
