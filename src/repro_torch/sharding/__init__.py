"""Sharding rules on ``DeviceMesh`` and DTensor placements (port of
``repro.sharding``)."""
