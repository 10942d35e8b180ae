"""Host-side helpers: numpy reductions, synthetic fixtures, device choice."""
