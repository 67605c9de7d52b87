"""Engine: device state and the scheduler tick."""
