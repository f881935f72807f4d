"""Domain constants: GKE TPU resource names and node labels."""
