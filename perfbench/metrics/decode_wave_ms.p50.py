"""Median host-clock ms of the engine steps that admitted nothing: one
decode wave over every slot."""
import statistics


def read(r):
    ms = [(ta - tb) * 1e3 for tb, ta, admitted in r["steps"] if admitted == 0]
    return statistics.median(ms) if ms else None
