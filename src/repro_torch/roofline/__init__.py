"""The card's roofline constants and the analytic parameter count the
simulator's cost model takes (``repro.roofline``)."""
