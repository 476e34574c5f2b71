"""In-memory test doubles for driving the service without a cluster."""
