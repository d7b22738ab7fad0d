"""Data layer: PNG IO and the on-disk session layouts."""
