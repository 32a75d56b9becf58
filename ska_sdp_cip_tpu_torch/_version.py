"""Package version (counterpart: ska_sdp_cip_tpu/_version.py)."""

__version__ = "0.1.0"
