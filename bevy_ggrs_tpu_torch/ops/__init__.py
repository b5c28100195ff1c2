"""Device work of the port: the frame engine and its branch axis
(``resim``), the speculation cache (``speculation``), packed uploads
(``packing``) and the checksum fold kernel (``checksum_fold``)."""
