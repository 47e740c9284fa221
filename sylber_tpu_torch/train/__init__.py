"""Distillation training of the port (stage 1 and stage 2, one device)."""
