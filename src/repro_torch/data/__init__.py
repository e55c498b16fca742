"""Host-side data for the LM path: the synthetic token corpus."""
