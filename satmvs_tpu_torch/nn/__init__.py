"""Network modules (FeatureNet, RED regularizer and their blocks)."""
