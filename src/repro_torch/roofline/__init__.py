"""The card's roofline constants, the analytic parameter and model flop
counts, the roofline cell (``repro.roofline``), and the op count that
stands in for the JAX package's HLO cost analysis (`op_cost`)."""
