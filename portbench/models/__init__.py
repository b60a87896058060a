"""Plain references of the benchmark's models, with the counts of their
operations. Each imports torch, numpy and its siblings only."""
