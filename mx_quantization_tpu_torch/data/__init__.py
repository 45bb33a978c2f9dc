"""Input pipelines (slice 7: the ImageNet validation folder)."""
