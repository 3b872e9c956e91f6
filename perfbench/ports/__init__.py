"""The port's configuration for each model type: ``<model_type>.py`` has
``model_config(run)``, which builds ``repro_torch``'s ``ModelConfig`` from
a configuration file's run values and refuses a value the port cannot
run."""
