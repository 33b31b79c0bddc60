"""LEVIR-CD data: host decode to uint8, batching, on-device normalisation."""
