"""Tiered execution: placement policies, the streaming weight manager and the scheduler."""
