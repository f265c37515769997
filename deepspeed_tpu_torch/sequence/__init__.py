from .cross_entropy import resolve_loss_impl

__all__ = ["resolve_loss_impl"]
