"""Files: the FITS reader and writers, the RICE codec, checkpoints."""
