"""The system under test: each model kind (a configuration's ``model`` key)
is a module of its own that builds the port's model from the data the
reference made (``reference/<model>.py``), on the run's device."""
