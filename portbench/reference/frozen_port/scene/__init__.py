"""Scene: input, the DemoScene render world and the Engine frame loop."""
