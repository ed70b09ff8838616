"""The benchmark's own inputs: frozen generators and the graph pipeline."""
