"""Registration pipelines: pairwise and multiscale ICP."""
