"""repro_torch.data -- the inverted index, the ingest pipeline and the
synthetic dataset twins (``synth``)."""
