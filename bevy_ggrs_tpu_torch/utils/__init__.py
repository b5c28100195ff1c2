"""Host-side helpers: frame arithmetic, device selection, tensor trees."""
