"""The paper's two applications (§5.2), SUMMA and BPMF, and the
reference's three examples: quickstart, train_100m and serve_lm."""
