"""Neural-network units and modules of the port: the training engine
(units, GD rules, evaluators, decision, TrainStep, StandardWorkflow),
the transformer LM stack and its KV-cached sampler."""
