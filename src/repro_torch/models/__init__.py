"""The GNN model families as ``nn.Module``s."""
