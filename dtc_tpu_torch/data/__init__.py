"""Training data: the synthetic token stream, the resumable packed
document stream (packing, tokenizer, FineWeb, held-out split) and
host->device prefetch."""
