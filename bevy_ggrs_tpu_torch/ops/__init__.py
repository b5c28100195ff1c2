"""Device work of the port: the frame engine (``resim``) and the checksum
fold kernel (``checksum_fold``)."""
