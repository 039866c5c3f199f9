"""Data side of the port: the BatVision loaders and the dataset factory,
the native decoder, the audio front end, the transport codec, the
host-to-device prefetch, the device cache and the synthetic corpus."""
