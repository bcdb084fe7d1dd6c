"""Host-side utilities copied from the reference: the metrics registry,
fault injection and memory-pool accounting."""
