"""Samplers: batched NUTS, its adaptation and the sample driver."""
