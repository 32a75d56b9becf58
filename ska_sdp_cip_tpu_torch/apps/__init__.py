"""Command-line entry points of the port (counterpart: ska_sdp_cip_tpu/apps)."""
