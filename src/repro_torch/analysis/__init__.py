"""Analyses of the port's dry run: ``roofline``, the three-term roofline
of a rank's step on the H100."""
