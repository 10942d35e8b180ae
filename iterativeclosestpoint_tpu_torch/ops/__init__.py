"""Device compute: geometry, brute-force NN and the slab-sweep NN."""
