"""HuBERT encoder of the port."""
