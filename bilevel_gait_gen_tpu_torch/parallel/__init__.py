"""Subpackage: parallel (scenario and alpha-lane sharding over
``torch.distributed``)."""
