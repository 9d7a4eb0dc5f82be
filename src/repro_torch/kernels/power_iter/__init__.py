"""Top eigenpair of each stream's PSD Gram by power iteration."""
