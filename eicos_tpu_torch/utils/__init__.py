"""Host-side helpers of the port (``printing``)."""
