"""Model zoo: text encoder, conditional 1-D UNet, TTSSingleSpeaker."""
