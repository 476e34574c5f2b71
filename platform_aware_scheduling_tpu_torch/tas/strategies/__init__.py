"""TAS policy strategies (the port's copies): dontschedule, on the exact
host path."""
