"""Data side of the port: the audio front end, the transport codec, the
synthetic corpus and the dataset factory."""
