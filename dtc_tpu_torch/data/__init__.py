"""Training data: the synthetic token stream and host->device prefetch."""
