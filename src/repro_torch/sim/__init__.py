"""The discrete-event cluster simulator (the reference launcher's
``--backend sim``), priced by ``serving/cost_model.py``."""
