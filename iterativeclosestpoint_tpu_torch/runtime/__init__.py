"""Runtime helpers: stage timing."""
