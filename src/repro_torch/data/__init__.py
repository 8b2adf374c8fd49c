"""repro_torch.data -- the inverted index."""
