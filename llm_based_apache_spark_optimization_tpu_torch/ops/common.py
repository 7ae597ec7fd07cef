"""Shared numerical constants for the ops."""

# Large-negative instead of -inf for masking: keeps softmax NaN-free on
# fully-masked rows and is representable in f32. Shared by attention masking
# and sampler logit masking so the semantics cannot diverge.
NEG_INF = -1e30
