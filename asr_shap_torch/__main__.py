from asr_shap_torch.cli import main

main()
