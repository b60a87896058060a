"""The benchmark's own machinery: the synthetic graphs, the weights, the
traced window's reduction, the import guard. Nothing here imports the
program at import time."""
